"""LM: init, the training loss, prefill and one-token decode, for the
dense, vlm, moe, ssm, hybrid and audio families.

Port of `repro.models.transformer`.  The reference's
nested parameter dict with stacked (L, ...) blocks becomes a `Transformer`
module holding `embed` (V, d), `unembed` (d, V), `final_norm` (d,) and an
`nn.ModuleList` of one `Block` per layer, plus the family extras: the
hybrid's one `shared_attn` block (zamba2, applied before every
`attn_every` SSM layers) and the audio family's `encoder` blocks and
`enc_final_norm` (whisper).  Weights keep the reference's (in, out)
layout (`x @ wq`), so carrying them across
(`repro_torch.convert.convert_lm`) is a plain copy.

A block's leaf may be C3-quantized (`quant/lm_quant.py`): then prefill
and decode take the reference's `param_transform`, applied to each
layer's leaves before the layer runs, which turns the indexes into the
operands `models.common.linear` multiplies.  As in the reference, it
maps `blocks` only, never `shared_attn` or the encoder.

The vlm family's layer is the dense layer; its stub CLIP frontend's patch
embeddings (B, n_patches, d) go before the text (`_maybe_concat_patches`)
and occupy cache positions.  `forward_train` runs with autograd, layer by
layer, rematerialised as the reference's `jax.checkpoint` regions are
(`REMAT_POLICIES`, `torch.utils.checkpoint`): each block of the dense,
vlm, moe and ssm families under `cfg.remat_policy`, the hybrid's
shared-attention groups with each SSM block nested inside, and the audio
family's encoder and decoder blocks, always saving nothing.  A region's
forward runs again in the backward; the numbers are those of keeping
every activation.

On a device mesh the parameters are DTensors (`launch/steps.py`
`shard_params`, by `param_specs`, the reference's logical axes) and the
forwards take the reference's `constraint` hook, which lays the (B, S, d)
residual out after the embedding and after every block; the ops DTensor
has no rule for run on each device's shards (`distributed/sharding.py`
`on_shards`), laid out by the sharding rules the constraint carries
(`sharding.rules_of`).  With `constraint=None` and plain tensors the ops
are the one-device ops.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Mapping, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as CK

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.models import mamba2 as M2
from repro_torch.models.attention import (KVCache, attention_cross,
                                          attention_decode, attention_encoder,
                                          attention_prefill, attention_train,
                                          init_attention)
from repro_torch.models.common import (ArchConfig, cross_entropy_loss,
                                       divided_axis, init_dense, init_ones,
                                       linear, relaid, rms_norm, swiglu)
from repro_torch.models.moe import init_moe, moe_ffn

_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
_KV_FAMILIES = ("dense", "vlm", "moe", "audio")


def _check_cfg(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(cfg.family)
    if cfg.family == "hybrid" and cfg.n_layers % _attn_every(cfg):
        raise ValueError(f"{cfg.n_layers} layers are not groups of "
                         f"attn_every = {_attn_every(cfg)}")


def _attn_every(cfg: ArchConfig) -> int:
    return cfg.attn_every or 6


def _attn_shapes(cfg: ArchConfig, prefix: str = "") -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {f"{prefix}wq": (d, h * hd), f"{prefix}wk": (d, kv * hd),
            f"{prefix}wv": (d, kv * hd), f"{prefix}wo": (h * hd, d)}


def _mlp_shapes(cfg: ArchConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {"mlp_wi": (d, ff), "mlp_wg": (d, ff), "mlp_wo": (ff, d)}


def _layer_shapes(cfg: ArchConfig) -> dict:
    """A block's leaves and their per-layer shapes."""
    d = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        d_in, nh, n, _ = M2.dims(cfg)
        ch = M2.conv_channels(cfg)
        return {"in_proj": (d, 2 * d_in + 2 * n + nh), "out_proj": (d_in, d),
                "conv_w": (ch, cfg.ssm_conv), "conv_b": (ch,), "A_log": (nh,),
                "D": (nh,), "dt_bias": (nh,), "gnorm": (d_in,), "ln1": (d,)}
    shapes = {**_attn_shapes(cfg), "ln1": (d,), "ln2": (d,)}
    if cfg.family == "moe":
        e, ff = cfg.n_experts, cfg.d_ff
        shapes.update(router=(d, e), moe_wi=(e, d, ff), moe_wg=(e, d, ff),
                      moe_wo=(e, ff, d))
    else:
        shapes.update(_mlp_shapes(cfg))
    if cfg.family == "audio":
        shapes.update(_attn_shapes(cfg, "x"), ln_x=(d,))
    return shapes


def _shared_shapes(cfg: ArchConfig) -> dict:
    """The hybrid's shared attention block (one, unstacked)."""
    return {**_attn_shapes(cfg), "ln_attn": (cfg.d_model,)}


def _encoder_shapes(cfg: ArchConfig) -> dict:
    """One audio encoder block."""
    d = cfg.d_model
    return {**_attn_shapes(cfg), "ln1": (d,), "ln2": (d,), **_mlp_shapes(cfg)}


def _shard_ssm_heads(cfg: ArchConfig) -> bool:
    """mamba2-130m has 24 heads (not divisible by tp=16): replicate heads."""
    _, nh, _, _ = M2.dims(cfg)
    return nh % 16 == 0


def _attn_axes(prefix: str = "") -> dict:
    return {f"{prefix}wq": ("embed", "heads"),
            f"{prefix}wk": ("embed", "kv_heads"),
            f"{prefix}wv": ("embed", "kv_heads"),
            f"{prefix}wo": ("heads", "embed")}


_MLP_AXES = {"mlp_wi": ("embed", "mlp"), "mlp_wg": ("embed", "mlp"),
             "mlp_wo": ("mlp", "embed")}


def _layer_axes(cfg: ArchConfig) -> dict:
    """A block's leaves and their logical axes (`_layer_shapes`' leaves;
    the reference's `Initializer` axes without the stacked "layers")."""
    if cfg.family in ("ssm", "hybrid"):
        h = "heads" if (cfg.family == "hybrid" or _shard_ssm_heads(cfg)) \
            else None
        return {"in_proj": ("embed", h), "out_proj": (h, "embed"),
                "conv_w": (h, None), "conv_b": (h,), "A_log": (h,),
                "D": (h,), "dt_bias": (h,), "gnorm": (h,), "ln1": (None,)}
    axes = {**_attn_axes(), "ln1": (None,), "ln2": (None,)}
    if cfg.family == "moe":
        axes.update(router=("embed", "experts"),
                    moe_wi=("experts", "embed", "mlp"),
                    moe_wg=("experts", "embed", "mlp"),
                    moe_wo=("experts", "mlp", "embed"))
    else:
        axes.update(_MLP_AXES)
    if cfg.family == "audio":
        axes.update(_attn_axes("x"), ln_x=(None,))
    return axes


def param_specs(cfg: ArchConfig) -> dict:
    """{parameter name: logical axes} for every parameter of the model
    `init_model(cfg)` builds, by its `named_parameters()` names: the
    reference's logical spec tree with each stacked leaf's "layers" axis
    dropped (`blocks.3.wq` is the reference's `blocks/wq` at layer 3)."""
    _check_cfg(cfg)
    out = {"embed": ("vocab", "embed"), "unembed": ("embed", "vocab"),
           "final_norm": (None,)}
    layer = _layer_axes(cfg)
    for i in range(cfg.n_layers):
        out.update({f"blocks.{i}.{k}": v for k, v in layer.items()})
    if cfg.family == "hybrid":
        out.update({f"shared_attn.{k}": v for k, v in
                    {**_attn_axes(), "ln_attn": (None,)}.items()})
    if cfg.family == "audio":
        enc = {**_attn_axes(), "ln1": (None,), "ln2": (None,), **_MLP_AXES}
        for i in range(cfg.enc_layers):
            out.update({f"encoder.{i}.{k}": v for k, v in enc.items()})
        out["enc_final_norm"] = (None,)
    return out


def _weight_shape(leaf) -> tuple:
    """The weight shape a leaf stands for: a tensor's own, or a quantized
    leaf's indexes (`idx4` holds two 4-bit indexes per byte)."""
    if not isinstance(leaf, Mapping):
        return tuple(leaf.shape)
    if "idx" in leaf:
        return tuple(leaf["idx"].shape)
    shape = tuple(leaf["idx4"].shape)
    return shape[:-1] + (2 * shape[-1],)


class Block(nn.Module):
    """One layer's leaves by the reference's names.  A tensor leaf is a
    parameter (`block["wq"]`); a C3-quantized leaf is a submodule holding
    the buffers `idx` (int8) or `idx4` (packed uint8) and `cb` (L,) f32,
    as the reference's `{"idx" | "idx4", "cb"}`."""

    def __init__(self, leaves: Mapping):
        super().__init__()
        for name, leaf in leaves.items():
            if isinstance(leaf, Mapping):
                q = nn.Module()
                for key, t in leaf.items():
                    q.register_buffer(key, t)
                self.add_module(name, q)
            else:
                self.register_parameter(name, nn.Parameter(leaf))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def leaves(self) -> dict:
        """{name: tensor, or {"idx" | "idx4": ..., "cb": ...}} — the
        reference's per-layer dict, which `param_transform` maps."""
        out = dict(self.named_parameters(recurse=False))
        out.update({name: dict(q.named_buffers())
                    for name, q in self.named_children()})
        return out


def _check_leaves(where: str, leaves: Mapping, shapes: dict, cfg) -> None:
    if set(leaves) != set(shapes):
        raise ValueError(f"{where} has {sorted(leaves)}, expected "
                         f"{sorted(shapes)}")
    for k, t in leaves.items():
        if _weight_shape(t) != shapes[k]:
            raise ValueError(f"{where}.{k}: shape {_weight_shape(t)}, "
                             f"expected {shapes[k]} for {cfg.name}")


class Transformer(nn.Module):
    """The LM's parameters, by the reference's names.  `shared_attn` (the
    hybrid family's) and `encoder` / `enc_final_norm` (the audio
    family's) are given exactly for their family."""

    def __init__(self, cfg: ArchConfig, embed: torch.Tensor,
                 unembed: torch.Tensor, final_norm: torch.Tensor,
                 blocks: list[dict], shared_attn: dict | None = None,
                 encoder: list[dict] | None = None,
                 enc_final_norm: torch.Tensor | None = None):
        super().__init__()
        _check_cfg(cfg)
        d = cfg.d_model
        _check_leaves("model", {"embed": embed, "unembed": unembed,
                                "final_norm": final_norm},
                      {"embed": (cfg.vocab, d), "unembed": (d, cfg.vocab),
                       "final_norm": (d,)}, cfg)
        if len(blocks) != cfg.n_layers:
            raise ValueError(f"{len(blocks)} blocks for {cfg.n_layers} "
                             f"layers")
        layer = _layer_shapes(cfg)
        for i, lp in enumerate(blocks):
            _check_leaves(f"blocks.{i}", lp, layer, cfg)
        hybrid, audio = cfg.family == "hybrid", cfg.family == "audio"
        if (shared_attn is not None) != hybrid:
            raise ValueError(f"shared_attn is for the hybrid family, not "
                             f"{cfg.family!r}")
        if (encoder is not None) != audio or (
                enc_final_norm is not None) != audio:
            raise ValueError(f"encoder and enc_final_norm are for the audio "
                             f"family, not {cfg.family!r}")
        if hybrid:
            _check_leaves("shared_attn", shared_attn, _shared_shapes(cfg),
                          cfg)
        if audio:
            if len(encoder) != cfg.enc_layers:
                raise ValueError(f"{len(encoder)} encoder blocks for "
                                 f"{cfg.enc_layers} layers")
            for i, lp in enumerate(encoder):
                _check_leaves(f"encoder.{i}", lp, _encoder_shapes(cfg), cfg)
            _check_leaves("model", {"enc_final_norm": enc_final_norm},
                          {"enc_final_norm": (d,)}, cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.unembed = nn.Parameter(unembed)
        self.final_norm = nn.Parameter(final_norm)
        self.blocks = nn.ModuleList(Block(lp) for lp in blocks)
        self.shared_attn = Block(shared_attn) if hybrid else None
        self.encoder = (nn.ModuleList(Block(lp) for lp in encoder)
                        if audio else None)
        self.enc_final_norm = (nn.Parameter(enc_final_norm) if audio
                               else None)

    def extras(self) -> dict:
        """The family extras as `Transformer` keyword arguments (leaves
        as `Block.leaves`), for a model that keeps them as they are."""
        if self.shared_attn is not None:
            return {"shared_attn": self.shared_attn.leaves()}
        if self.encoder is not None:
            return {"encoder": [b.leaves() for b in self.encoder],
                    "enc_final_norm": self.enc_final_norm}
        return {}


_F32_LEAVES = ("A_log", "D", "dt_bias")     # f32 whatever cfg.dtype is


def param_shapes(cfg: ArchConfig) -> dict:
    """{parameter name: (shape, dtype)} of the model `init_model(cfg)`
    builds, in its `named_parameters()` order, with nothing allocated."""
    _check_cfg(cfg)
    d = cfg.d_model

    def leaf(name, shape):
        return tuple(shape), (torch.float32 if name in _F32_LEAVES
                              else cfg.dtype)

    out = {"embed": leaf("embed", (cfg.vocab, d)),
           "unembed": leaf("unembed", (d, cfg.vocab)),
           "final_norm": leaf("final_norm", (d,))}
    if cfg.family == "audio":
        out["enc_final_norm"] = leaf("enc_final_norm", (d,))
    layer = _layer_shapes(cfg)
    for i in range(cfg.n_layers):
        out.update({f"blocks.{i}.{k}": leaf(k, v) for k, v in layer.items()})
    if cfg.family == "hybrid":
        out.update({f"shared_attn.{k}": leaf(k, v)
                    for k, v in _shared_shapes(cfg).items()})
    if cfg.family == "audio":
        for i in range(cfg.enc_layers):
            out.update({f"encoder.{i}.{k}": leaf(k, v)
                        for k, v in _encoder_shapes(cfg).items()})
    return out


def model_from(cfg: ArchConfig, tensors: Mapping[str, torch.Tensor]
               ) -> Transformer:
    """A `Transformer` holding `tensors`, keyed by parameter name as
    `param_shapes` lists them (plain tensors, or DTensors on a mesh)."""
    def group(prefix: str, n: int) -> list:
        return [{k.split(".", 2)[2]: t for k, t in tensors.items()
                 if k.startswith(f"{prefix}.{i}.")} for i in range(n)]

    extras = {}
    if cfg.family == "hybrid":
        extras["shared_attn"] = {k.split(".", 1)[1]: t
                                 for k, t in tensors.items()
                                 if k.startswith("shared_attn.")}
    if cfg.family == "audio":
        extras["encoder"] = group("encoder", cfg.enc_layers)
        extras["enc_final_norm"] = tensors["enc_final_norm"]
    return Transformer(cfg, tensors["embed"], tensors["unembed"],
                       tensors["final_norm"], group("blocks", cfg.n_layers),
                       **extras)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_mlp(gen: torch.Generator, cfg: ArchConfig, n_layers: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mlp_wi": init_dense(gen, (d, ff), cfg.dtype),
        "mlp_wg": init_dense(gen, (d, ff), cfg.dtype),
        "mlp_wo": init_dense(gen, (ff, d), cfg.dtype,
                             scale=ff ** -0.5 / (2 * max(n_layers, 1)) ** 0.5),
    }


def init_model(cfg: ArchConfig, gen: torch.Generator) -> Transformer:
    """Random weights with the reference's names and scales, drawn from
    the seeded `gen` on its device (the reference's numbers are not
    reproduced: the generators differ)."""
    _check_cfg(cfg)
    L, d = cfg.n_layers, cfg.d_model
    embed = init_dense(gen, (cfg.vocab, d), cfg.dtype, scale=1.0)
    unembed = init_dense(gen, (d, cfg.vocab), cfg.dtype)
    final_norm = init_ones(gen, (d,), cfg.dtype)
    extras = {}
    blocks = []
    for _ in range(L):
        if cfg.family in ("ssm", "hybrid"):
            lp = M2.init_mamba2(gen, cfg, L)
            lp["ln1"] = init_ones(gen, (d,), cfg.dtype)
        else:
            lp = init_attention(gen, cfg, L, cross=cfg.family == "audio")
            lp["ln1"] = init_ones(gen, (d,), cfg.dtype)
            lp["ln2"] = init_ones(gen, (d,), cfg.dtype)
            if cfg.family == "audio":
                lp["ln_x"] = init_ones(gen, (d,), cfg.dtype)
            lp.update(init_moe(gen, cfg, L) if cfg.family == "moe"
                      else _init_mlp(gen, cfg, L))
        blocks.append(lp)
    if cfg.family == "hybrid":
        # one *shared* attention block (zamba2), applied every attn_every
        extras["shared_attn"] = dict(init_attention(gen, cfg, 0),
                                     ln_attn=init_ones(gen, (d,), cfg.dtype))
    elif cfg.family == "audio":
        EL = cfg.enc_layers
        extras["encoder"] = [
            dict(init_attention(gen, cfg, EL),
                 ln1=init_ones(gen, (d,), cfg.dtype),
                 ln2=init_ones(gen, (d,), cfg.dtype), **_init_mlp(gen, cfg, EL))
            for _ in range(EL)]
        extras["enc_final_norm"] = init_ones(gen, (d,), cfg.dtype)
    return Transformer(cfg, embed, unembed, final_norm, blocks, **extras)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _ffn(y, lp, cfg: ArchConfig, rules: SH.ShardingRules = SH.ShardingRules()):
    """The block's feed-forward: (output, aux loss)."""
    if cfg.family == "moe":
        return moe_ffn(y, lp, cfg, rules)
    return swiglu(y, lp["mlp_wi"], lp["mlp_wg"], lp["mlp_wo"]), 0.0


def _constrained(constraint: Callable | None, x):
    """The reference's residual `constraint` hook (a mesh layout for the
    (B, S, d) residual, `distributed.sharding.make_residual_constraint`);
    None issues no op."""
    return x if constraint is None else constraint(x)


def _attn_mlp_block(x, lp, cfg: ArchConfig, constraint: Callable | None = None):
    """One block of the train / prefill compute; returns (x, aux)."""
    rules = SH.rules_of(constraint)
    h = attention_train(rms_norm(x, lp["ln1"], cfg.norm_eps), lp, cfg,
                        rules=rules)
    x = x + h
    y = rms_norm(x, lp["ln2"], cfg.norm_eps)
    f, aux = _ffn(y, lp, cfg, rules)
    if cfg.constrain_ffn_out:
        # shard the ffn output before the residual add: the partial-sum
        # all-reduce becomes reduce-scatter + local add
        f = _constrained(constraint, f)
    return x + f, aux


def _ssm_block(x, lp, cfg: ArchConfig, rules: SH.ShardingRules = SH.ShardingRules()):
    return x + M2.mamba2_forward(rms_norm(x, lp["ln1"], cfg.norm_eps), lp,
                                 cfg, rules=rules)


def _encoder_forward(params: Transformer, cfg: ArchConfig, frames,
                     constraint: Callable | None = None, remat: bool = False):
    """whisper encoder over stub frame embeddings (B, F, d); in training
    (`remat`) each block is one region saving nothing."""
    x = _as_input(frames.to(cfg.dtype), params.enc_final_norm)
    run = REMAT_POLICIES["nothing" if remat else "everything"]

    def body(c, lp):
        c = c + attention_encoder(rms_norm(c, lp["ln1"], cfg.norm_eps), lp,
                                  cfg, rules=SH.rules_of(constraint))
        c = c + swiglu(rms_norm(c, lp["ln2"], cfg.norm_eps), lp["mlp_wi"],
                       lp["mlp_wg"], lp["mlp_wo"])
        return _constrained(constraint, c)

    for lp in params.encoder:
        x = run(body, x, lp)
    return rms_norm(x, params.enc_final_norm, cfg.norm_eps)


def _layer_params(block: Block, param_transform: Callable | None):
    """A layer's leaves as the layer reads them: the block itself, or
    `param_transform` of its leaves (the reference applies it inside the
    layer scan, before the layer)."""
    return block if param_transform is None else param_transform(
        block.leaves())


def embed_tokens(params: Transformer, cfg: ArchConfig, tokens: torch.Tensor,
                 rules: SH.ShardingRules = SH.ShardingRules()) -> torch.Tensor:
    """The rows of `embed` (V, d) at `tokens` (`F.embedding`); a DTensor
    `embed` sharded over its vocab takes `_embed_vocab_parallel`."""
    embed = params.embed.to(cfg.dtype)
    mesh = _mesh_of(embed)
    if mesh is not None and SH.nontrivial(SH.entry_of(embed, 0),
                                          mesh) is not None:
        return _embed_vocab_parallel(embed, tokens, rules)
    return F.embedding(tokens.long(), embed)


def _embed_vocab_parallel(embed, tokens, rules: SH.ShardingRules):
    """The vocab-parallel lookup: each device looks its own rows of the
    table up (zero for tokens outside them); the partial rows, stacked on
    a new leading dim sharded over the vocab's axes, are summed (DTensor's
    reduction).  Where the table's d is split too (FSDP), one of two
    routes, chosen from the shapes before any collective moves: each
    device looks up its rows of the batch in its vocab rows of the whole
    table, d gathered (a table block of V / |vocab axes| rows), or, where
    the rows looked up are fewer than that block's (every decode step),
    the table stays as it lies and each device looks up, in its (vocab,
    d) block, the tokens of every batch shard that shares its d axes:
    only the looked-up rows move.  Both are exact, so both are bitwise
    the one-device lookup.  DTensor's own embedding rule (a masked
    partial) fails once the batch is sharded on another axis of a 2-D
    mesh."""
    mesh = embed.device_mesh
    pv, pd = SH.entry_of(embed, 0), SH.nontrivial(SH.entry_of(embed, 1),
                                                   mesh)
    pb = SH.free_of(SH.spec_for((tokens.shape[0],), ("batch",), mesh,
                                rules)[0], pv)
    n_rows = embed.to_local().shape[0]
    off = SH.shard_index(mesh, pv) * n_rows

    def local(w, t):
        t = t.long() - off
        hit = (t >= 0) & (t < n_rows)
        rows = F.embedding(torch.clamp(t, 0, n_rows - 1), w)
        return (rows * hit[..., None].to(rows.dtype))[None]

    rest = [None] * (tokens.dim() - 1)
    if pd is None or _rows_looked_up(tokens, pb, mesh) >= n_rows:
        return SH.on_shards(local, mesh, (embed, tokens),
                            (SH.P(pv, None), SH.P(pb, *rest)),
                            SH.P(pv, pb, *rest, None)).sum(dim=0)
    pt = SH.free_of(pb, pd)
    rows = SH.on_shards(local, mesh, (embed, tokens),
                        (SH.P(pv, pd), SH.P(pt, *rest)),
                        SH.P(pv, pt, *rest, pd)).sum(dim=0)
    return rows.redistribute(mesh, SH.placements(SH.P(pb, *rest, None),
                                                 mesh))


def _rows_looked_up(tokens, pb, mesh) -> int:
    """How many tokens one device's shard of the batch holds, the batch
    (tokens' dim 0) split on `pb`."""
    return tokens.numel() // (1 if pb is None else SH._axis_size(
        SH.mesh_sizes(mesh), pb))


def _as_input(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A plain input tensor `t` beside DTensor parameters (`like`): a
    DTensor replicated on like's mesh, so the ops that mix the two are
    DTensor ops; on one device `t` itself."""
    mesh = _mesh_of(like)
    return t if mesh is None else SH.replicated(t, mesh)


def _maybe_concat_patches(x, batch: dict, cfg: ArchConfig):
    """vlm: the patch embeddings (B, n_patches, d) before the text."""
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([_as_input(batch["patch_embeds"], x).to(x.dtype), x],
                      dim=1)
    return x


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """`dots_with_no_batch_dims_saveable`: keep the outputs of the 2-D
    products (`aten.mm` / `aten.addmm`, every `linear`), recompute the
    rest: the batched products (attention scores, the moe expert einsums,
    the SSD scan's), the flash route's `autograd.Function` and every
    elementwise op."""
    return (CK.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CK.CheckpointPolicy.PREFER_RECOMPUTE)


def _run_saving_nothing(fn, *args):
    return CK.checkpoint(fn, *args, use_reentrant=False,
                         preserve_rng_state=False)


def _run_saving_dots(fn, *args):
    return CK.checkpoint(fn, *args, use_reentrant=False,
                         preserve_rng_state=False,
                         context_fn=functools.partial(
                             CK.create_selective_checkpoint_contexts,
                             _save_dots))


def _run_saving_everything(fn, *args):
    return fn(*args)


# The reference's `REMAT_POLICIES` (jax.checkpoint policies) as runners
# `run(fn, *args)` of one rematerialised region: "nothing" keeps only the
# region's inputs and recomputes its forward in the backward, "dots"
# also keeps the 2-D products' outputs (`_save_dots`), "everything" keeps
# every activation (no recompute).  The forwards draw no random numbers,
# so no RNG state is kept.
REMAT_POLICIES = {"nothing": _run_saving_nothing, "dots": _run_saving_dots,
                  "everything": _run_saving_everything}


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

def forward_train(params: Transformer, cfg: ArchConfig, batch: dict,
                  constraint: Callable | None = None) -> torch.Tensor:
    """The scalar training loss, differentiable in `params`.

    batch: tokens (B, S), labels (B, S), optional loss_mask (B, S); the
    vlm family's optional patch_embeds (B, n_patches, d), the audio
    family's frames (B, enc_frames, d).  The loss is taken on text
    positions only; the moe family adds 0.01 times the sum of its layers'
    load-balancing terms.  `constraint`, the reference's hook, lays out
    the (B, S, d) residual after the embedding and after every block
    (`distributed.sharding.make_residual_constraint` on a mesh); None
    issues no op.  The blocks are rematerialised as the reference's are:
    `cfg.remat_policy` names what a dense, vlm, moe or ssm block keeps
    for the backward (`REMAT_POLICIES`; an unknown name raises KeyError).
    """
    _check_cfg(cfg)
    rules = SH.rules_of(constraint)
    x = embed_tokens(params, cfg, batch["tokens"], rules)
    x = _maybe_concat_patches(x, batch, cfg)
    x = _constrained(constraint, x)
    aux_total = 0.0
    if cfg.family == "hybrid":
        x = _hybrid_forward(x, params, cfg, constraint)
    elif cfg.family == "audio":
        enc = _encoder_forward(params, cfg, batch["frames"], constraint,
                               remat=True)
        x = _decoder_forward(x, params, cfg, enc, constraint)
    else:
        x, auxs = _remat_blocks(x, params, cfg, constraint)
        if cfg.family == "moe":
            aux_total = _replicated(0.01 * torch.stack(auxs).sum())
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = x[:, batch["patch_embeds"].shape[1]:]     # loss on text positions
    logits = linear(x, params.unembed.to(cfg.dtype))
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"),
                              rules=rules)
    return loss + aux_total


def _replicated(t):
    """A DTensor replicated on every mesh axis: the experts' aux terms
    are a partial sum and the loss a partial mean, and torch 2.11's
    DTensor cannot turn one partial type into the other when they are
    added (2.13 replicates the sum); a plain tensor as it is."""
    if not SH.is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, SH.placements(SH.P(), t.device_mesh))


def _remat_blocks(x, params: Transformer, cfg: ArchConfig,
                  constraint: Callable | None = None):
    """The dense, vlm, moe and ssm layers, each block and the residual
    constraint after it one region under `cfg.remat_policy` (the
    reference's `_scan_blocks`); returns (x, [aux per layer])."""
    run = REMAT_POLICIES[cfg.remat_policy]
    rules = SH.rules_of(constraint)

    def body(c, block):
        if cfg.family == "ssm":
            out, aux = _ssm_block(c, block, cfg, rules), 0.0
        else:
            out, aux = _attn_mlp_block(c, block, cfg, constraint)
        return _constrained(constraint, out), aux

    auxs = []
    for block in params.blocks:
        x, aux = run(body, x, block)
        auxs.append(aux)
    return x, auxs


def _hybrid_forward(x, params: Transformer, cfg: ArchConfig,
                    constraint: Callable | None = None):
    """zamba2: the shared attention block before every `attn_every` SSM
    layers.  Each group (the shared block and its SSM layers) is one
    region saving nothing, and each SSM block inside it another, nested
    (the reference's checkpointed group scan over checkpointed blocks)."""
    sp = params.shared_attn
    rules = SH.rules_of(constraint)
    run = REMAT_POLICIES["nothing"]

    def ssm(c, block):
        return _constrained(constraint, _ssm_block(c, block, cfg, rules))

    def group(c, blocks):
        c = c + attention_train(rms_norm(c, sp["ln_attn"], cfg.norm_eps),
                                sp, cfg, rules=rules)
        c = _constrained(constraint, c)
        for block in blocks:
            c = run(ssm, c, block)
        return c

    k = _attn_every(cfg)
    blocks = list(params.blocks)
    for first in range(0, len(blocks), k):
        x = run(group, x, blocks[first:first + k])
    return x


def _decoder_forward(x, params: Transformer, cfg: ArchConfig, enc,
                     constraint: Callable | None = None):
    """whisper decoder over the encoder output `enc` (B, F, d); each
    block one region saving nothing."""
    eps = cfg.norm_eps
    rules = SH.rules_of(constraint)

    def body(c, lp):
        c = c + attention_train(rms_norm(c, lp["ln1"], eps), lp, cfg,
                                rules=rules)
        c = c + attention_cross(rms_norm(c, lp["ln_x"], eps), enc, lp, cfg,
                                rules=rules)
        c = c + swiglu(rms_norm(c, lp["ln2"], eps), lp["mlp_wi"],
                       lp["mlp_wg"], lp["mlp_wo"])
        return _constrained(constraint, c)

    for lp in params.blocks:
        x = REMAT_POLICIES["nothing"](body, x, lp)
    return x


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """Per-family stacked caches + current position (the reference's
    fields; a field the family does not use is ())."""

    kv: Any            # KVCache stacked (L, B, kv, S, hd) or () if unused
    ssm: Any           # SSMCache stacked (L, ...) or ()
    shared_kv: Any     # hybrid: (groups, B, kv, S, hd) for the shared block
    enc_out: Any       # audio: encoder output (B, F, d)
    pos: torch.Tensor  # 0-d int32


def _zeros_on(device, mesh=None) -> Callable:
    """`zeros(shape, dtype)`: a zero tensor on `device`; with a mesh, a
    DTensor laid out by `distributed.sharding.decode_state_spec`, each
    device allocating only its shard."""
    if mesh is None:
        return lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                                device=device)

    def zeros(shape, dtype):
        spec = SH.decode_state_spec(tuple(shape), mesh)
        return SH.from_shard(torch.zeros(SH.local_shape(shape, spec, mesh),
                                         dtype=dtype, device=device),
                             shape, spec, mesh)
    return zeros


def _kv_stack(cfg: ArchConfig, n: int, batch: int, cache_len: int, dtype,
              zeros: Callable) -> KVCache:
    shape = (n, batch, cfg.n_kv_heads, cache_len, cfg.hd)
    return KVCache(k=zeros(shape, dtype), v=zeros(shape, dtype))


def _caches(cfg: ArchConfig, batch: int, cache_len: int, kv_dtype, device,
            mesh=None) -> dict:
    """The family's empty stacked caches: `kv` (one per layer), `ssm`
    (conv windows in cfg.dtype, states f32) and the hybrid's `shared_kv`
    (one per group of `attn_every` layers); on `mesh` when given."""
    L = cfg.n_layers
    zeros = _zeros_on(device, mesh)
    out = {"kv": (), "ssm": (), "shared_kv": ()}
    if cfg.family in _KV_FAMILIES:
        out["kv"] = _kv_stack(cfg, L, batch, cache_len, kv_dtype, zeros)
    if cfg.family in ("ssm", "hybrid"):
        one = M2.init_cache(cfg, batch, cfg.dtype, "meta")
        out["ssm"] = M2.SSMCache(*(zeros((L, *t.shape), t.dtype)
                                   for t in one))
    if cfg.family == "hybrid":
        out["shared_kv"] = _kv_stack(cfg, L // _attn_every(cfg), batch,
                                     cache_len, kv_dtype, zeros)
    return out


def _mesh_of(t: torch.Tensor):
    """The DeviceMesh of a DTensor, else None."""
    return t.device_mesh if SH.is_dtensor(t) else None


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      device=None, mesh=None) -> DecodeState:
    """Empty caches on `device` (default: the card); on a `DeviceMesh`,
    DTensors laid out by `distributed.sharding.decode_state_spec`."""
    _check_cfg(cfg)
    device = resolve_device(device)
    dt = cfg.kv_cache_dtype or cfg.dtype     # int8 KV cache perf option
    enc = ()
    if cfg.family == "audio":
        enc = _zeros_on(device, mesh)((batch, cfg.enc_frames, cfg.d_model),
                                      cfg.dtype)
    return DecodeState(**_caches(cfg, batch, cache_len, dt, device, mesh),
                       enc_out=enc,
                       pos=torch.zeros((), dtype=torch.int32, device=device))


def _logits(params: Transformer, cfg: ArchConfig, x: torch.Tensor,
            rules: SH.ShardingRules = SH.ShardingRules()) -> torch.Tensor:
    """The serving logits of x (..., d).  On a mesh whose "vocab" axis
    would repeat the whole product on each of its devices (a vocab it
    does not divide, so the unembedding is split over d alone: FSDP), the
    vocab is split there unevenly, as `common._vocab_layout` splits it,
    the unembedding's d gathered: each device computes its rows' logits
    for its slice of the vocab (`common.divided_axis`)."""
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    w = params.unembed.to(cfg.dtype)
    if SH.is_dtensor(x) and SH.is_dtensor(w) and SH.entry_of(w, 1) is None:
        axis = divided_axis(x, w, rules.get("vocab"))
        if axis is not None:
            w = relaid(w, SH.P(None, axis), x.device_mesh)
    return linear(x, w)


def _group(cfg: ArchConfig, layer: int) -> int | None:
    """The hybrid's shared-attention group that `layer` opens, else
    None: the shared block runs before every `attn_every` SSM layers."""
    if cfg.family != "hybrid" or layer % _attn_every(cfg):
        return None
    return layer // _attn_every(cfg)


def _group_end(cfg: ArchConfig, layer: int, constraint, x):
    """The residual constraint after an SSM layer: after every layer, or
    for the hybrid after the last layer of each shared-attention group
    (the reference constrains its group scan's carry)."""
    if cfg.family == "hybrid" and (layer + 1) % _attn_every(cfg):
        return x
    return _constrained(constraint, x)


def _stack_slice(stack, i: int):
    """Layer (or group) i's view of a stacked KVCache / SSMCache."""
    return type(stack)(*(t[i] for t in stack))


@torch.no_grad()
def forward_decode(params: Transformer, cfg: ArchConfig, state: DecodeState,
                   tokens: torch.Tensor,
                   param_transform: Callable | None = None,
                   constraint: Callable | None = None):
    """One-token decode.  tokens (B, 1) -> (logits (B, V), new state).

    The caches of `state` are updated in place (layer l's KV slot `pos`,
    SSM window and state, and the hybrid's shared KV slot are written
    through views of the stacks), so the returned state holds the same
    cache tensors with `pos + 1`; the reference returns new arrays.
    `param_transform` is the C3 codebook hook
    (`quant.lm_quant.make_param_transform`), applied to each layer's
    leaves before the layer runs.  `constraint` as in `forward_train`,
    after the embedding and after every layer (the hybrid: every group).
    """
    _check_cfg(cfg)
    eps = cfg.norm_eps
    rules = SH.rules_of(constraint)
    x = _constrained(constraint, embed_tokens(params, cfg, tokens, rules))
    pos = state.pos
    for layer, block in enumerate(params.blocks):
        group = _group(cfg, layer)
        if group is not None:
            sp = params.shared_attn
            h, _ = attention_decode(rms_norm(x, sp["ln_attn"], eps), sp, cfg,
                                    _stack_slice(state.shared_kv, group), pos,
                                    rules=rules)
            x = x + h
        lp = _layer_params(block, param_transform)
        if cfg.family in ("ssm", "hybrid"):
            cache = _stack_slice(state.ssm, layer)
            h, new = M2.mamba2_decode(rms_norm(x, lp["ln1"], eps), lp, cfg,
                                      cache)
            cache.conv.copy_(new.conv)
            cache.state.copy_(new.state)
            x = _group_end(cfg, layer, constraint, x + h)
            continue
        h, _ = attention_decode(rms_norm(x, lp["ln1"], eps), lp, cfg,
                                _stack_slice(state.kv, layer), pos,
                                rules=rules)
        x = x + h
        if cfg.family == "audio":
            x = x + attention_cross(rms_norm(x, lp["ln_x"], eps),
                                    state.enc_out, lp, cfg, rules=rules)
        f, _ = _ffn(rms_norm(x, lp["ln2"], eps), lp, cfg, rules)
        x = _constrained(constraint, x + f)
    return (_logits(params, cfg, x, rules)[:, 0],
            state._replace(pos=pos + 1))


@torch.no_grad()
def forward_prefill(params: Transformer, cfg: ArchConfig, batch: dict,
                    cache_len: int, param_transform: Callable | None = None,
                    constraint: Callable | None = None):
    """Prefill a prompt (B, S); returns (last-token logits, DecodeState).

    Full forward + cache population: each layer writes its k / v (or its
    SSM conv window and state) into its slice of one stack of x's type
    (states f32), as the reference's prefill caches are; the audio family
    first runs the encoder over `batch["frames"]` (B, enc_frames, d); the
    vlm family puts `batch["patch_embeds"]` (B, n_patches, d), when given,
    before the text, so `pos` is n_patches + S and the cache must hold
    them too.  `param_transform` and `constraint` as in `forward_decode`.
    On a mesh the caches are laid out by
    `distributed.sharding.decode_state_spec`.
    """
    _check_cfg(cfg)
    eps = cfg.norm_eps
    rules = SH.rules_of(constraint)
    x = embed_tokens(params, cfg, batch["tokens"], rules)
    x = _constrained(constraint, _maybe_concat_patches(x, batch, cfg))
    b, s = x.shape[:2]           # vlm: patches occupy cache positions too
    caches = _caches(cfg, b, cache_len, x.dtype, x.device,
                     _mesh_of(params.embed))
    enc = ()
    if cfg.family == "audio":
        enc = _encoder_forward(params, cfg, batch["frames"], constraint)
    for layer, block in enumerate(params.blocks):
        group = _group(cfg, layer)
        if group is not None:
            sp = params.shared_attn
            h, _ = attention_prefill(rms_norm(x, sp["ln_attn"], eps), sp, cfg,
                                     cache_len,
                                     _stack_slice(caches["shared_kv"], group),
                                     rules=rules)
            x = x + h
        lp = _layer_params(block, param_transform)
        if cfg.family in ("ssm", "hybrid"):
            h, _ = M2.mamba2_forward(rms_norm(x, lp["ln1"], eps), lp, cfg,
                                     _stack_slice(caches["ssm"], layer),
                                     return_cache=True, rules=rules)
            x = _group_end(cfg, layer, constraint, x + h)
            continue
        h, _ = attention_prefill(rms_norm(x, lp["ln1"], eps), lp, cfg,
                                 cache_len, _stack_slice(caches["kv"], layer),
                                 rules=rules)
        x = x + h
        if cfg.family == "audio":
            x = x + attention_cross(rms_norm(x, lp["ln_x"], eps), enc, lp,
                                    cfg, rules=rules)
        f, _ = _ffn(rms_norm(x, lp["ln2"], eps), lp, cfg, rules)
        x = _constrained(constraint, x + f)
    state = DecodeState(**caches, enc_out=enc,
                        pos=torch.tensor(s, dtype=torch.int32,
                                         device=x.device))
    return _logits(params, cfg, x[:, -1], rules), state
