"""GQA attention with RoPE, sliding window, prefill + decode KV-cache paths.

Port of `repro.models.attention`: causal self-attention for prefill and
decode, and the audio family's bidirectional `attention_encoder` and
`attention_cross` (plain SDPA, never the flash route).

Flash route: train / prefill self-attention goes through
`kernels.flash_attention` whenever the shape qualifies (`_flash_ok`: a
sequence that is a multiple of 128 and longer than 128, no sliding
window) and the kernel launches for it (`flash_attention.supports`: the
type, head dim and B·H); every other shape runs `_sdpa`, the reference's
default.  The choice is made before the call and is the same on the CPU
and the card: the hand-written kernel for CUDA tensors, its plain version
for CPU tensors.  The reference takes that route only under
``REPRO_FLASH_ATTENTION=1``, an opt-in for a TPU kernel that otherwise
runs in interpret mode; the port reads no such switch.  The route is
differentiable (`_FlashCore`): the backward is the exact gradient of the
reference SDPA, as the reference's custom VJP computes it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 supports)
from repro_torch.models.common import (ArchConfig, apply_rope, init_dense,
                                       linear)

NEG_INF = -1e30


def _flash_ok(cfg: ArchConfig, s: int) -> bool:
    return s % 128 == 0 and s > 128 and cfg.sliding_window <= 0


def _flash_route(q, cfg: ArchConfig) -> bool:
    """The flash route for q (B, S, H, hd): a qualifying sequence and a
    shape the kernel launches for."""
    b, s, h, hd = q.shape
    return _flash_ok(cfg, s) and supports(q.dtype, hd, b, h)


class _FlashCore(torch.autograd.Function):
    """The reference's `_flash_core` with its custom VJP.  Forward:
    `flash_attention` on (B, H, S, hd) q and (B, KV, S, hd) k / v (the
    kernel for CUDA tensors, its plain version for CPU tensors).
    Backward: the exact gradient of the reference SDPA with each kv head
    repeated over its group (the reference's `_flash_core_bwd`), by
    autograd of `flash_attention_plain` recomputed from the saved q, k, v:
    O(S·T) memory on the backward only, and no kernel launch."""

    @staticmethod
    def forward(ctx, qh, kh, vh):
        ctx.save_for_backward(qh, kh, vh)
        return flash_attention(qh, kh, vh, causal=True)

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
            out = flash_attention_plain(*leaves, causal=True)
            return torch.autograd.grad(out, leaves, g.to(qh.dtype))


def _sdpa_flash(q, k, v):
    """Causal SDPA through the flash kernel.

    q (B,S,H,hd), k/v (B,S,kv,hd) -> (B,S,H*hd).  Numerics: online
    softmax in f32 — matches `_sdpa` to float tolerance, not bit-exactly.
    Differentiable through `_FlashCore`.
    """
    b, s, h, hd = q.shape
    out = _FlashCore.apply(q.transpose(1, 2).contiguous(),
                           k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous())
    return out.transpose(1, 2).reshape(b, s, h * hd).to(v.dtype)


def init_attention(gen: torch.Generator, cfg: ArchConfig, n_layers: int,
                   cross: bool = False) -> dict:
    """One layer's self-attention weights, (in, out) layout; `n_layers`
    sets the `wo` scale.  `cross` adds the cross-attention's `xw*`."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": init_dense(gen, (d, h * hd), cfg.dtype),
        "wk": init_dense(gen, (d, kv * hd), cfg.dtype),
        "wv": init_dense(gen, (d, kv * hd), cfg.dtype),
        "wo": init_dense(gen, (h * hd, d), cfg.dtype,
                         scale=(h * hd) ** -0.5 / (2 * max(n_layers, 1)) ** 0.5),
    }
    if cross:
        p.update(xwq=init_dense(gen, (d, h * hd), cfg.dtype),
                 xwk=init_dense(gen, (d, kv * hd), cfg.dtype),
                 xwv=init_dense(gen, (d, kv * hd), cfg.dtype),
                 xwo=init_dense(gen, (h * hd, d), cfg.dtype))
    return p


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, kv, S_max, hd)
    v: torch.Tensor   # (B, kv, S_max, hd)


def _qkv(x, p, cfg: ArchConfig, positions, rope: bool = True,
         q_name="wq", k_name="wk", v_name="wv"):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(x, p[q_name]).reshape(b, s, h, hd)
    k = linear(x, p[k_name]).reshape(b, s, kv, hd)
    v = linear(x, p[v_name]).reshape(b, s, kv, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: ArchConfig):
    """q (B,S,H,hd), k/v (B,T,kv,hd) -> (B,S,H*hd); GQA via head grouping.

    Scores in f32 (the storage type's products are exact in f32), softmax
    in f32, probs cast back to the storage type for the PV product, which
    accumulates in f32 (the reference's preferred_element_type).  `mask`
    (B, S, T) bool, or None for full attention (the reference's all-true
    mask).
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    # each kv head's g query heads as rows of one product: (b, kv, g*s, hd)
    qg = q.reshape(b, s, kv, g, hd).permute(0, 2, 3, 1, 4).reshape(
        b, kv, g * s, hd).float()
    kt = k.permute(0, 2, 3, 1).float()                  # (b, kv, hd, t)
    vt = v.permute(0, 2, 1, 3).float()                  # (b, kv, t, hd)
    scores = (qg @ kt).reshape(b, kv, g, s, t) / (hd ** 0.5)
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = probs.to(v.dtype).float().reshape(b, kv, g * s, t) @ vt
    return (out.reshape(b, kv, g, s, hd).permute(0, 3, 1, 2, 4)
            .reshape(b, s, h * hd).to(v.dtype))


def _sdpa_chunked(q, k, v, cfg: ArchConfig, chunk: int):
    """Query-chunked attention (flash-style memory behaviour).

    Live score tensor shrinks from O(S·T) to O(chunk·T) per head.  Each
    chunk's softmax row is complete, so no online max/sum bookkeeping is
    needed; numerics match `_sdpa` exactly.
    """
    b, s, h, hd = q.shape
    t = k.shape[1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    cols = torch.arange(t, device=q.device)
    outs = []
    for ci in range(s // chunk):
        rows = ci * chunk + torch.arange(chunk, device=q.device)
        m = cols[None, :] <= rows[:, None]
        if cfg.sliding_window > 0:
            m &= cols[None, :] > rows[:, None] - cfg.sliding_window
        qc = q[:, ci * chunk:(ci + 1) * chunk]
        outs.append(_sdpa(qc, k, v, m.expand(b, chunk, t), cfg))
    return torch.cat(outs, dim=1)


def causal_mask(s: int, window: int = 0, offset: int = 0, device=None
                ) -> torch.Tensor:
    """(s, s+offset) causal (optionally sliding-window) mask."""
    rows = torch.arange(s, device=device)[:, None] + offset
    cols = torch.arange(s + offset, device=device)[None, :]
    m = cols <= rows
    if window > 0:
        m &= cols > rows - window
    return m


def _self_attention(q, k, v, cfg: ArchConfig):
    b, s = q.shape[:2]
    if _flash_route(q, cfg):
        return _sdpa_flash(q, k, v)
    if cfg.attn_chunk and s % cfg.attn_chunk == 0 and s > cfg.attn_chunk:
        return _sdpa_chunked(q, k, v, cfg, cfg.attn_chunk)
    mask = causal_mask(s, cfg.sliding_window, device=q.device)[None]
    return _sdpa(q, k, v, mask.expand(b, s, s), cfg)


def attention_train(x, p, cfg: ArchConfig, positions=None):
    """Full self-attention forward (train / prefill compute)."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(x, p, cfg, positions)
    return linear(_self_attention(q, k, v, cfg), p["wo"])


def attention_encoder(x, p, cfg: ArchConfig):
    """Bidirectional attention (whisper encoder)."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(x, p, cfg, positions)
    return linear(_sdpa(q, k, v, None, cfg), p["wo"])


def attention_cross(x, enc_out, p, cfg: ArchConfig):
    """Cross-attention: queries from decoder x, keys/values from encoder."""
    b, s, _ = x.shape
    t = enc_out.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(x, p["xwq"]).reshape(b, s, h, hd)
    k = linear(enc_out, p["xwk"]).reshape(b, t, kv, hd)
    v = linear(enc_out, p["xwv"]).reshape(b, t, kv, hd)
    return linear(_sdpa(q, k, v, None, cfg), p["xwo"])


def attention_prefill(x, p, cfg: ArchConfig, cache_len: int,
                      cache: KVCache | None = None):
    """Prefill: same compute as train + returns the populated KV cache.

    `cache`, when given, is a (B, kv, cache_len, hd) pair that receives
    k and v in place (the caller's layer slice of the stacked cache);
    otherwise new zero caches of x's type are made.
    """
    b, s, _ = x.shape
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of "
                         f"{cache_len}")
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(x, p, cfg, positions)
    out = _self_attention(q, k, v, cfg)
    if cache is None:
        kc = torch.zeros((b, cfg.n_kv_heads, cache_len, cfg.hd),
                         dtype=x.dtype, device=x.device)
        cache = KVCache(kc, torch.zeros_like(kc))
    cache.k[:, :, :s] = k.transpose(1, 2)
    cache.v[:, :, :s] = v.transpose(1, 2)
    return linear(out, p["wo"]), cache


KV_INT8_SCALE = 0.05    # fixed-point step for int8 KV caches (perf option)


def _quant_kv(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.float() / KV_INT8_SCALE),
                           -127, 127).to(torch.int8)
    return x.to(dtype)


def _dequant_kv(x: torch.Tensor, out_dtype) -> torch.Tensor:
    if x.dtype == torch.int8:
        return (x.float() * KV_INT8_SCALE).to(out_dtype)
    return x


def attention_decode(x, p, cfg: ArchConfig, cache: KVCache,
                     pos: torch.Tensor):
    """One-token decode against a (B, kv, S_max, hd) cache.

    `pos` is the current length (0-d int tensor, uniform across batch).
    The new token's k / v are written into `cache` in place, at slot
    `pos % S_max` (a ring buffer when the cache is smaller than the
    context, for sliding-window archs: the mask then admits the full
    rotated window; softmax is order-invariant, so causal semantics hold);
    the returned KVCache holds the same tensors.  int8 caches
    (cfg.kv_cache_dtype) store round(x / KV_INT8_SCALE).
    """
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    positions = pos.reshape(1, 1)
    q, k, v = _qkv(x, p, cfg, positions)
    t = cache.k.shape[2]
    write_pos = (pos % t).reshape(1).long()             # ring buffer when t<ctx
    cache.k.index_copy_(2, write_pos,
                        _quant_kv(k.transpose(1, 2), cache.k.dtype))
    cache.v.index_copy_(2, write_pos,
                        _quant_kv(v.transpose(1, 2), cache.v.dtype))

    slots = torch.arange(t, device=x.device)[None, :]
    valid = slots <= pos                                # normal operation
    if cfg.sliding_window > 0:
        if cfg.sliding_window < t:
            valid &= slots > pos - cfg.sliding_window
        else:                                           # ring buffer full
            valid = valid | (pos >= t)
    mask = valid[:, None, :].expand(b, 1, t)
    kd = _dequant_kv(cache.k, x.dtype).transpose(1, 2)
    vd = _dequant_kv(cache.v, x.dtype).transpose(1, 2)
    out = _sdpa(q, kd, vd, mask, cfg)
    return linear(out, p["wo"]), cache
