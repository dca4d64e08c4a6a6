"""Mixture-of-Experts layer: top-k routing with capacity-bounded
group-local dispatch (mesh-TF / t5x style).

Port of `repro.models.moe`.  Tokens are reshaped into G groups of
`group_size`; each group dispatches into per-expert capacity buffers by
one-hot products, so dispatch tensors stay O(tokens * k * cf),
independent of E.  The reference's expert-parallel sharding over its
mesh has no counterpart on one card: the dispatch, the expert SwiGLU and
the combine are `torch.einsum` products (large batched GEMMs, which the
reference computes outside any Pallas kernel too).  The router product
goes through `linear`, so a C3-quantized router runs on the
`codebook_matmul` kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, init_dense, linear


def init_moe(gen: torch.Generator, cfg: ArchConfig, n_layers: int) -> dict:
    """One layer's router and expert stacks with the reference's scales.
    A 3-D stack's default scale is shape[0] ** -0.5 (E, not d), as the
    reference's `Initializer.dense` takes fan_in = shape[0]."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": init_dense(gen, (d, e), cfg.dtype, scale=d ** -0.5),
        "moe_wi": init_dense(gen, (e, d, ff), cfg.dtype),
        "moe_wg": init_dense(gen, (e, d, ff), cfg.dtype),
        "moe_wo": init_dense(gen, (e, ff, d), cfg.dtype,
                             scale=ff ** -0.5 / (2 * n_layers) ** 0.5),
    }


def capacity(cfg: ArchConfig, group_size: int) -> int:
    c = int(group_size * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, cfg.top_k)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of int indexes; an index outside [0, n) gives a zero
    row, as `jax.nn.one_hot` does (`F.one_hot` raises instead)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k_dispatch(probs: torch.Tensor, k: int, cap: int):
    """probs (G, S, E) -> dispatch (G, S, E, C) f32 {0, 1}, combine same.

    Position-in-expert by a cumulative sum in routing priority order (the
    k-th choice of every token after all (k-1)-th choices, t5x
    convention).  Overflowing tokens are dropped (their combine weight is
    0).  `torch.argmax` returns the first maximum, as `jnp.argmax` does.
    """
    g, s, e = probs.shape
    remaining = probs
    fill = torch.zeros((g, e), dtype=torch.float32, device=probs.device)
    dispatch = torch.zeros((g, s, e, cap), dtype=torch.float32,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    for _ in range(k):
        onehot = _one_hot(torch.argmax(remaining, dim=-1), e)    # (G, S, E)
        gate = torch.sum(probs * onehot, dim=-1)                 # (G, S)
        # position of each token within its expert's buffer this round
        pos_in_e = torch.cumsum(onehot, dim=1) - onehot + fill[:, None, :]
        pos = torch.sum(pos_in_e * onehot, dim=-1)               # (G, S)
        keep = pos < cap
        pos_oh = _one_hot(pos.to(torch.int32), cap)
        d = onehot[..., None] * pos_oh[:, :, None, :] * keep[..., None, None]
        dispatch = dispatch + d
        combine = combine + d * gate[..., None, None]
        fill = fill + torch.sum(onehot * keep[..., None], dim=1)
        remaining = remaining * (1.0 - onehot)
    return dispatch, combine


def moe_ffn(x: torch.Tensor, p, cfg: ArchConfig):
    """x (B, S, d) -> ((B, S, d), aux load-balancing loss as a 0-d f32).

    The group size is the largest divisor of B * S not above
    `cfg.moe_group_size`; router logits are computed in x's type, then
    widened to f32 for the softmax, as in the reference.
    """
    b, s, d = x.shape
    tokens = b * s
    gs = min(cfg.moe_group_size, tokens)
    while tokens % gs != 0:          # largest divisor <= preferred size
        gs -= 1
    g = tokens // gs
    xg = x.reshape(g, gs, d)

    logits = linear(xg, p["router"]).float()
    probs = F.softmax(logits, dim=-1)
    cap = capacity(cfg, gs)
    dispatch, combine = top_k_dispatch(probs, cfg.top_k, cap)

    # aux loss (Switch-style load balancing)
    density = dispatch.sum(dim=(1, 3)) / gs                      # (G, E)
    router_mean = probs.mean(dim=1)                              # (G, E)
    aux = torch.mean(density * router_mean) * cfg.n_experts ** 2

    xin = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xg)
    h = (torch.einsum("egcd,edf->egcf", xin, p["moe_wi"])
         * F.silu(torch.einsum("egcd,edf->egcf", xin, p["moe_wg"])))
    out_e = torch.einsum("egcf,efd->egcd", h, p["moe_wo"])
    out = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), out_e)
    return out.reshape(b, s, d), aux
