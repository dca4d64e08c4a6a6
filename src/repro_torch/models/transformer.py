"""Dense LM: init, prefill and one-token decode.

Port of `repro.models.transformer` for the dense family.  The reference's
nested parameter dict with stacked (L, ...) blocks becomes a `Transformer`
module holding `embed` (V, d), `unembed` (d, V), `final_norm` (d,) and an
`nn.ModuleList` of one `nn.ParameterDict` per layer.  Weights keep the
reference's (in, out) layout (`x @ wq`), so carrying them across
(`repro_torch.convert.convert_lm`) is a plain copy.

The other families and `quant_serving` raise `NotImplementedError`
naming the ROADMAP item that brings them; training (`forward_train`)
comes with ROADMAP Queue 1 #20.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import (KVCache, attention_decode,
                                          attention_prefill, attention_train,
                                          init_attention)
from repro_torch.models.common import (ArchConfig, init_dense, init_ones,
                                       rms_norm, swiglu)

# family -> the ROADMAP item (Queue 1) that ports it
_FAMILY_ITEMS = {
    "moe": "#16 (models/moe.py)",
    "ssm": "#17 (models/mamba2.py)",
    "hybrid": "#17 (models/mamba2.py)",
    "audio": "#18 (encoder, cross-attention)",
    "vlm": "#19 (patch embeddings)",
}


def _check_cfg(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        item = _FAMILY_ITEMS.get(cfg.family)
        if item is None:
            raise ValueError(cfg.family)
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(ROADMAP Queue 1 {item})")
    if cfg.quant_serving:
        raise NotImplementedError("quant_serving (C3 codebook weights) comes "
                                  "with quant/lm_quant.py, ROADMAP Queue 1 "
                                  "#15")


def _layer_shapes(cfg: ArchConfig) -> dict:
    d, h, kv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    return {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
            "wo": (h * hd, d), "ln1": (d,), "ln2": (d,), "mlp_wi": (d, ff),
            "mlp_wg": (d, ff), "mlp_wo": (ff, d)}


class Transformer(nn.Module):
    """The dense LM's parameters, by the reference's names."""

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
            if tuple(t.shape) != want[name]:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{want[name]} for {cfg.name}")
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.unembed = nn.Parameter(unembed)
        self.final_norm = nn.Parameter(final_norm)
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(t) for k, t in lp.items()})
            for lp in blocks)


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
        lp.update(_init_mlp(gen, cfg, L))
        blocks.append(lp)
    return Transformer(cfg, embed, unembed, final_norm, blocks)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _attn_mlp_block(x, lp, cfg: ArchConfig):
    """One dense block of the train / prefill compute; returns (x, aux)."""
    h = attention_train(rms_norm(x, lp["ln1"], cfg.norm_eps), lp, cfg)
    x = x + h
    y = rms_norm(x, lp["ln2"], cfg.norm_eps)
    f = swiglu(y, lp["mlp_wi"], lp["mlp_wg"], lp["mlp_wo"])
    return x + f, 0.0


def embed_tokens(params: Transformer, cfg: ArchConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    return params.embed.to(cfg.dtype)[tokens.long()]


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """Per-family stacked caches + current position (the reference's
    fields; the dense family uses `kv` and `pos`, the others are ())."""

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
                   tokens: torch.Tensor):
    """One-token decode.  tokens (B, 1) -> (logits (B, V), new state).

    The KV stack of `state` is updated in place (layer l's slot `pos` is
    written through a view of the stack), so the returned state holds the
    same cache tensors with `pos + 1`; the reference returns new arrays.
    """
    _check_cfg(cfg)
    x = embed_tokens(params, cfg, tokens)
    pos = state.pos
    for layer, lp in enumerate(params.blocks):
        cache = KVCache(state.kv.k[layer], state.kv.v[layer])
        h, _ = attention_decode(rms_norm(x, lp["ln1"], cfg.norm_eps), lp,
                                cfg, cache, pos)
        x = x + h
        y = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(y, lp["mlp_wi"], lp["mlp_wg"], lp["mlp_wo"])
    return _logits(params, cfg, x)[:, 0], state._replace(pos=pos + 1)


@torch.no_grad()
def forward_prefill(params: Transformer, cfg: ArchConfig, batch: dict,
                    cache_len: int):
    """Prefill a prompt (B, S); returns (last-token logits, DecodeState).

    Full forward + cache population: each layer writes its k / v into its
    slice of one (L, B, kv, cache_len, hd) stack of x's type, as the
    reference's prefill caches are.
    """
    _check_cfg(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    kv = _kv_stack(cfg, b, cache_len, x.dtype, x.device)
    for layer, lp in enumerate(params.blocks):
        h, _ = attention_prefill(rms_norm(x, lp["ln1"], cfg.norm_eps), lp,
                                 cfg, cache_len,
                                 KVCache(kv.k[layer], kv.v[layer]))
        x = x + h
        y = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(y, lp["mlp_wi"], lp["mlp_wg"], lp["mlp_wo"])
    state = DecodeState(kv=kv, ssm=(), shared_kv=(), enc_out=(),
                        pos=torch.tensor(s, dtype=torch.int32,
                                         device=x.device))
    return _logits(params, cfg, x[:, -1]), state
