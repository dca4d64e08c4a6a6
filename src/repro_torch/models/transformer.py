"""LM: init, prefill and one-token decode, for the dense and moe families.

Port of `repro.models.transformer` for those families.  The reference's
nested parameter dict with stacked (L, ...) blocks becomes a `Transformer`
module holding `embed` (V, d), `unembed` (d, V), `final_norm` (d,) and an
`nn.ModuleList` of one `Block` per layer.  Weights keep the reference's
(in, out) layout (`x @ wq`), so carrying them across
(`repro_torch.convert.convert_lm`) is a plain copy.

A block's leaf may be C3-quantized (`quant/lm_quant.py`): then prefill
and decode take the reference's `param_transform`, applied to each
layer's leaves before the layer runs, which turns the indexes into the
operands `models.common.linear` multiplies.

The ssm, hybrid, audio and vlm families raise `NotImplementedError`
naming the ROADMAP item that brings them; training (`forward_train`)
comes with ROADMAP Queue 1 #20.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import (KVCache, attention_decode,
                                          attention_prefill, attention_train,
                                          init_attention)
from repro_torch.models.common import (ArchConfig, init_dense, init_ones,
                                       rms_norm, swiglu)
from repro_torch.models.moe import init_moe, moe_ffn

# family -> the ROADMAP item (Queue 1) that ports it
_FAMILY_ITEMS = {
    "ssm": "#17 (models/mamba2.py)",
    "hybrid": "#17 (models/mamba2.py)",
    "audio": "#18 (encoder, cross-attention)",
    "vlm": "#19 (patch embeddings)",
}


def _check_cfg(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        item = _FAMILY_ITEMS.get(cfg.family)
        if item is None:
            raise ValueError(cfg.family)
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(ROADMAP Queue 1 {item})")


def _layer_shapes(cfg: ArchConfig) -> dict:
    d, h, kv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
              "wo": (h * hd, d), "ln1": (d,), "ln2": (d,)}
    if cfg.family == "moe":
        e = cfg.n_experts
        shapes.update(router=(d, e), moe_wi=(e, d, ff), moe_wg=(e, d, ff),
                      moe_wo=(e, ff, d))
    else:
        shapes.update(mlp_wi=(d, ff), mlp_wg=(d, ff), mlp_wo=(ff, d))
    return shapes


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


class Transformer(nn.Module):
    """The LM's parameters, by the reference's names."""

    def __init__(self, cfg: ArchConfig, embed: torch.Tensor,
                 unembed: torch.Tensor, final_norm: torch.Tensor,
                 blocks: list[dict]):
        super().__init__()
        _check_cfg(cfg)
        want = {"embed": (cfg.vocab, cfg.d_model),
                "unembed": (cfg.d_model, cfg.vocab),
                "final_norm": (cfg.d_model,)}
        got = {"embed": embed, "unembed": unembed, "final_norm": final_norm}
        if len(blocks) != cfg.n_layers:
            raise ValueError(f"{len(blocks)} blocks for {cfg.n_layers} "
                             f"layers")
        layer = _layer_shapes(cfg)
        for i, lp in enumerate(blocks):
            if set(lp) != set(layer):
                raise ValueError(f"block {i} has {sorted(lp)}, expected "
                                 f"{sorted(layer)}")
            got.update({f"blocks.{i}.{k}": t for k, t in lp.items()})
            want.update({f"blocks.{i}.{k}": s for k, s in layer.items()})
        for name, t in got.items():
            if _weight_shape(t) != want[name]:
                raise ValueError(f"{name}: shape {_weight_shape(t)}, "
                                 f"expected {want[name]} for {cfg.name}")
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.unembed = nn.Parameter(unembed)
        self.final_norm = nn.Parameter(final_norm)
        self.blocks = nn.ModuleList(Block(lp) for lp in blocks)


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
    L = cfg.n_layers
    embed = init_dense(gen, (cfg.vocab, cfg.d_model), cfg.dtype, scale=1.0)
    unembed = init_dense(gen, (cfg.d_model, cfg.vocab), cfg.dtype)
    final_norm = init_ones(gen, (cfg.d_model,), cfg.dtype)
    blocks = []
    for _ in range(L):
        lp = init_attention(gen, cfg, L)
        lp["ln1"] = init_ones(gen, (cfg.d_model,), cfg.dtype)
        lp["ln2"] = init_ones(gen, (cfg.d_model,), cfg.dtype)
        lp.update(init_moe(gen, cfg, L) if cfg.family == "moe"
                  else _init_mlp(gen, cfg, L))
        blocks.append(lp)
    return Transformer(cfg, embed, unembed, final_norm, blocks)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _ffn(y, lp, cfg: ArchConfig):
    """The block's feed-forward: (output, aux loss)."""
    if cfg.family == "moe":
        return moe_ffn(y, lp, cfg)
    return swiglu(y, lp["mlp_wi"], lp["mlp_wg"], lp["mlp_wo"]), 0.0


def _attn_mlp_block(x, lp, cfg: ArchConfig):
    """One block of the train / prefill compute; returns (x, aux)."""
    h = attention_train(rms_norm(x, lp["ln1"], cfg.norm_eps), lp, cfg)
    x = x + h
    y = rms_norm(x, lp["ln2"], cfg.norm_eps)
    f, aux = _ffn(y, lp, cfg)
    return x + f, aux


def _layer_params(block: Block, param_transform: Callable | None):
    """A layer's leaves as the layer reads them: the block itself, or
    `param_transform` of its leaves (the reference applies it inside the
    layer scan, before the layer)."""
    return block if param_transform is None else param_transform(
        block.leaves())


def embed_tokens(params: Transformer, cfg: ArchConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    return params.embed.to(cfg.dtype)[tokens.long()]


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """Per-family stacked caches + current position (the reference's
    fields; the dense and moe families use `kv` and `pos`, the others
    are ())."""

    kv: Any            # KVCache stacked (L, B, kv, S, hd) or () if unused
    ssm: Any           # SSMCache stacked (L, ...) or ()
    shared_kv: Any     # hybrid: (groups, B, kv, S, hd) for the shared block
    enc_out: Any       # audio: encoder output (B, F, d)
    pos: torch.Tensor  # 0-d int32


def _kv_stack(cfg: ArchConfig, batch: int, cache_len: int, dtype, device
              ) -> KVCache:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cache_len, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      device=None) -> DecodeState:
    """Empty caches on `device` (default: the card)."""
    _check_cfg(cfg)
    device = resolve_device(device)
    dt = cfg.kv_cache_dtype or cfg.dtype     # int8 KV cache perf option
    return DecodeState(kv=_kv_stack(cfg, batch, cache_len, dt, device),
                       ssm=(), shared_kv=(), enc_out=(),
                       pos=torch.zeros((), dtype=torch.int32, device=device))


def _logits(params: Transformer, cfg: ArchConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.unembed.to(cfg.dtype)


@torch.no_grad()
def forward_decode(params: Transformer, cfg: ArchConfig, state: DecodeState,
                   tokens: torch.Tensor,
                   param_transform: Callable | None = None):
    """One-token decode.  tokens (B, 1) -> (logits (B, V), new state).

    The KV stack of `state` is updated in place (layer l's slot `pos` is
    written through a view of the stack), so the returned state holds the
    same cache tensors with `pos + 1`; the reference returns new arrays.
    `param_transform` is the C3 codebook hook
    (`quant.lm_quant.make_param_transform`), applied to each layer's
    leaves before the layer runs.
    """
    _check_cfg(cfg)
    x = embed_tokens(params, cfg, tokens)
    pos = state.pos
    for layer, block in enumerate(params.blocks):
        lp = _layer_params(block, param_transform)
        cache = KVCache(state.kv.k[layer], state.kv.v[layer])
        h, _ = attention_decode(rms_norm(x, lp["ln1"], cfg.norm_eps), lp,
                                cfg, cache, pos)
        x = x + h
        f, _ = _ffn(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg)
        x = x + f
    return _logits(params, cfg, x)[:, 0], state._replace(pos=pos + 1)


@torch.no_grad()
def forward_prefill(params: Transformer, cfg: ArchConfig, batch: dict,
                    cache_len: int, param_transform: Callable | None = None):
    """Prefill a prompt (B, S); returns (last-token logits, DecodeState).

    Full forward + cache population: each layer writes its k / v into its
    slice of one (L, B, kv, cache_len, hd) stack of x's type, as the
    reference's prefill caches are.  `param_transform` as in
    `forward_decode`.
    """
    _check_cfg(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    kv = _kv_stack(cfg, b, cache_len, x.dtype, x.device)
    for layer, block in enumerate(params.blocks):
        lp = _layer_params(block, param_transform)
        h, _ = attention_prefill(rms_norm(x, lp["ln1"], cfg.norm_eps), lp,
                                 cfg, cache_len,
                                 KVCache(kv.k[layer], kv.v[layer]))
        x = x + h
        f, _ = _ffn(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg)
        x = x + f
    state = DecodeState(kv=kv, ssm=(), shared_kv=(), enc_out=(),
                        pos=torch.tensor(s, dtype=torch.int32,
                                         device=x.device))
    return _logits(params, cfg, x[:, -1]), state
