"""Mamba2 (SSD — state-space duality, arXiv:2405.21060).

Port of `repro.models.mamba2`: the chunked SSD scan for prefill (linear in
the sequence, with quadratic blocks inside a chunk) and the one-step
recurrence for decode, in plain PyTorch.  The reference's three
multi-operand einsums are contracted pairwise, as batched matmuls over
(batch, chunk, head): a broadcast to the 6-D (b, c, i, j, h, p) product
would need 5.4 GB per zamba2-2.7b layer at B 4, S 512.

A layer's weights are one dict (`init_mamba2`), read through
`models.common.linear` for `in_proj` / `out_proj`, so a C3-quantized
projection runs on the `codebook_matmul` kernel.  A quantized `conv_w`
(C3 quantizes it where the stacked leaf is large enough) is not a
product: it is read dense, as the reference's `cb[idx]`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as SH
from repro_torch.models.common import (ArchConfig, CodebookWeight,
                                       gather_codebook, init_dense,
                                       init_ones, linear, rms_norm)


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, K-1, conv_ch) rolling conv window
    state: torch.Tensor   # (B, H, N, P) SSM state, f32


def dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_state, cfg.ssm_head_dim


def conv_channels(cfg: ArchConfig) -> int:
    d_in, _, n, _ = dims(cfg)
    return d_in + 2 * n


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, n_layers: int
                ) -> dict:
    """One layer's weights, (in, out) layout; `n_layers` sets the
    `out_proj` scale.  `A_log`, `D` and `dt_bias` are f32 whatever
    `cfg.dtype` is, as in the reference."""
    d = cfg.d_model
    d_in, nh, n, _ = dims(cfg)
    ch = conv_channels(cfg)
    dev = gen.device
    return {
        "in_proj": init_dense(gen, (d, 2 * d_in + 2 * n + nh), cfg.dtype),
        "out_proj": init_dense(gen, (d_in, d), cfg.dtype,
                               scale=d_in ** -0.5 / (2 * n_layers) ** 0.5),
        "conv_w": init_dense(gen, (ch, cfg.ssm_conv), cfg.dtype,
                             scale=cfg.ssm_conv ** -0.5),
        "conv_b": torch.zeros((ch,), dtype=cfg.dtype, device=dev),
        # A_log init so that -exp(A_log) in [-1, ...): uniform-ish
        "A_log": init_ones(gen, (nh,), torch.float32),
        "D": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "gnorm": init_ones(gen, (d_in,), cfg.dtype),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    d_in, nh, n, _ = dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, n, n, nh], dim=-1)


def _conv_weight(w) -> torch.Tensor:
    """The conv kernel (CH, K) as a tensor: a C3 leaf's `cb[idx]` (its
    codebook is already rounded to the serving type)."""
    if isinstance(w, CodebookWeight):
        return gather_codebook(w)
    return w


def _conv_on_shards(xbc, w, b, rules: SH.ShardingRules):
    """The causal conv on a mesh: each device convolves its rows of the
    batch with the whole kernel (DTensor's convolution backward cannot
    take a replicated kernel)."""
    mesh = xbc.device_mesh
    pb = SH.spec_for((xbc.shape[0],), ("batch",), mesh, rules)[0]
    return SH.on_shards(_causal_conv_train, mesh, (xbc, w, b),
                        (SH.P(pb, None, None), SH.P(None, None), SH.P(None)),
                        SH.P(pb, None, None))


def _causal_conv_train(xbc: torch.Tensor, w, b: torch.Tensor,
                       rules: SH.ShardingRules = SH.ShardingRules()
                       ) -> torch.Tensor:
    """Depthwise causal conv, (B, S, CH) with kernel (CH, K): a
    cross-correlation over K - 1 zeros of left pad, in x's type."""
    w = _conv_weight(w)
    if SH.is_dtensor(xbc):
        return _conv_on_shards(xbc, w, b, rules)
    k = w.shape[-1]
    pad = F.pad(xbc, (0, 0, k - 1, 0)).transpose(1, 2)      # (B, CH, S+K-1)
    out = F.conv1d(pad, w[:, None, :].to(xbc.dtype), groups=xbc.shape[-1])
    out = out.transpose(1, 2)
    return F.silu(out + b.to(out.dtype))


def _causal_conv_step(xbc: torch.Tensor, conv_state: torch.Tensor, w, b):
    """One-token conv: (B, 1, CH) with rolling state (B, K-1, CH); the
    window product in f32."""
    w = _conv_weight(w)
    k = w.shape[-1]
    if conv_state.shape[1] != k - 1:
        raise ValueError(f"conv window of {conv_state.shape[1]} rows, the "
                         f"kernel needs ssm_conv - 1 = {k - 1}")
    window = torch.cat([conv_state, xbc], dim=1)             # (B, K, CH)
    out = (window.float() * w.float().T).sum(dim=1, keepdim=True)
    return F.silu(out + b.float()).to(xbc.dtype), window[:, 1:, :]


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """SSD scan.  x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n).

    Returns (y (b,s,h,p), final_state (b,h,n,p)), both f32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    dA_cum = torch.cumsum(dtc * A, dim=2)                 # (b,nc,l,h), negative
    xt = xc.permute(0, 1, 3, 2, 4)                        # (b,nc,h,l,p)

    # --- intra-chunk (quadratic in chunk length) ---
    diff = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (b,nc,i,j,h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    L = torch.where(tri[None, None, :, :, None], torch.exp(diff),
                    torch.zeros((), device=x.device))
    CB = Cc @ Bc.transpose(-1, -2)                        # (b,nc,i,j)
    w_intra = L * dtc[:, :, None, :, :] * CB[..., None]   # (b,nc,i,j,h)
    y_intra = w_intra.permute(0, 1, 4, 2, 3) @ xt         # (b,nc,h,i,p)

    # --- chunk end-states ---
    wts = torch.exp(dA_cum[:, :, -1:, :] - dA_cum) * dtc  # (b,nc,l,h)
    wx = wts.permute(0, 1, 3, 2)[..., None] * xt          # (b,nc,h,l,p)
    S = Bc.transpose(-1, -2)[:, :, None] @ wx             # (b,nc,h,n,p)

    # --- inter-chunk recurrence: the state entering each chunk ---
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])          # (b,nc,h)
    carry = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + S[:, c]
    S_prev = torch.stack(entering, dim=1)                 # (b,nc,h,n,p)

    # --- inter-chunk contribution ---
    y_inter = (Cc[:, :, None] @ S_prev) * torch.exp(
        dA_cum).permute(0, 1, 3, 2)[..., None]            # (b,nc,h,l,p)
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    return y, carry


def _scan(xin, dt, B, C, A_log, dt_bias, D, hp: int, chunk: int):
    """The SSD part of `mamba2_forward`: (y (b, s, nh * hp) f32 with the
    D skip, the final state (b, nh, n, hp) f32) from the conv's x, B, C
    and the raw dt."""
    b, s, d_in = xin.shape
    nh = d_in // hp
    A = -torch.exp(A_log.float())
    dt_act = F.softplus(dt.float() + dt_bias)
    xh = xin.reshape(b, s, nh, hp)
    # pad the sequence at the end to a chunk multiple; dt_act is padded
    # after softplus with zeros, so padded steps neither decay the state
    # nor add to it
    pad = (-s) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt_act = F.pad(dt_act, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, final = ssd_chunked(xh, dt_act, A, B, C, chunk)
    y = y[:, :s] + D[None, None, :, None] * xin.reshape(
        b, s, nh, hp).float()
    return y.reshape(b, s, d_in), final


def _scan_on_shards(scan, rules: SH.ShardingRules, xin, dt, B, C, A_log,
                    dt_bias, D):
    """`_scan` on a mesh: each device scans its rows of the batch and its
    SSD heads (the heads on the axis the layer's `A_log` is sharded on,
    else all of them), with B and C whole: the scan's hundreds of small
    ops then run on plain local tensors, not through DTensor's layout
    propagation (which also cannot split (..., heads * hp) once it has
    sharded it off the heads)."""
    mesh = xin.device_mesh
    ph = SH.entry_of(A_log, 0) if SH.is_dtensor(A_log) else None
    pb = SH.free_of(SH.spec_for((xin.shape[0],), ("batch",), mesh,
                                rules)[0], ph)
    rows = SH.P(pb, None, ph)
    heads = SH.P(ph)
    return SH.on_shards(scan, mesh, (xin, dt, B, C, A_log, dt_bias, D),
                        (rows, rows, SH.P(pb, None, None),
                         SH.P(pb, None, None), heads, heads, heads),
                        (rows, SH.P(pb, ph, None, None)))


def mamba2_forward(x, p, cfg: ArchConfig, cache: SSMCache | None = None,
                   return_cache: bool = False, *,
                   rules: SH.ShardingRules = SH.ShardingRules()):
    """Full-sequence forward (train / prefill).  x (B, S, d).

    With `return_cache`, also the cache a decode step continues from: the
    raw conv window (the last K - 1 inputs of the conv) and the final
    state.  `cache`, when given, is a (B, K-1, CH) / (B, H, N, P) pair
    that receives them in place (the caller's layer slice of the stacked
    cache); the reference takes and ignores a `cache` argument.
    """
    b, s, _ = x.shape
    d_in, nh, n, hp = dims(cfg)
    k = cfg.ssm_conv
    if return_cache and s < k - 1:
        raise ValueError(
            f"a prompt of {s} tokens leaves a conv window of {s} rows, "
            f"shorter than ssm_conv - 1 = {k - 1}: the reference's decode "
            f"step fails on it")
    z, xin, B, C, dt = _split_proj(linear(x, p["in_proj"]), cfg)
    pre_conv_xbc = torch.cat([xin, B, C], dim=-1)
    xbc = _causal_conv_train(pre_conv_xbc, p["conv_w"], p["conv_b"], rules)
    xin, B, C = torch.split(xbc, [d_in, n, n], dim=-1)
    scan = functools.partial(_scan, hp=hp, chunk=cfg.ssm_chunk)
    args = (xin, dt, B, C, p["A_log"], p["dt_bias"], p["D"])
    if SH.is_dtensor(xin):
        y, final = _scan_on_shards(scan, rules, *args)
    else:
        y, final = scan(*args)
    y = y.to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    out = linear(y, p["out_proj"])
    if not return_cache:
        return out
    tail = pre_conv_xbc[:, s - (k - 1):, :]               # raw conv window
    if cache is None:
        return out, SSMCache(conv=tail, state=final)
    cache.conv.copy_(tail)
    cache.state.copy_(final)
    return out, cache


def mamba2_decode(x, p, cfg: ArchConfig, cache: SSMCache):
    """One-token step.  x (B, 1, d) -> (B, 1, d), new cache."""
    b = x.shape[0]
    d_in, nh, n, hp = dims(cfg)
    z, xin, B, C, dt = _split_proj(linear(x, p["in_proj"]), cfg)
    raw_xbc = torch.cat([xin, B, C], dim=-1)              # (B, 1, CH)
    xbc, new_conv = _causal_conv_step(raw_xbc, cache.conv, p["conv_w"],
                                      p["conv_b"])
    xin, B, C = torch.split(xbc, [d_in, n, n], dim=-1)

    A = -torch.exp(p["A_log"].float())                    # (h,)
    dt_act = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B, h)
    xh = xin[:, 0].reshape(b, nh, hp).float()
    Bv = B[:, 0].float()                                  # (B, n)
    Cv = C[:, 0].float()
    decay = torch.exp(dt_act * A)                         # (B, h)
    upd = (dt_act[:, :, None] * Bv[:, None, :])[..., None] * xh[:, :, None]
    state = cache.state.float() * decay[..., None, None] + upd   # (B,h,n,p)
    y = (Cv[:, None, None, :] @ state)[:, :, 0]           # (B, h, p)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    out = linear(y, p["out_proj"])
    return out, SSMCache(conv=new_conv, state=state)


def init_cache(cfg: ArchConfig, batch: int, dtype, device=None) -> SSMCache:
    d_in, nh, n, hp = dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_channels(cfg)),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, nh, n, hp), dtype=torch.float32,
                          device=device),
    )
