"""Mixture-of-Experts layer: top-k routing with capacity-bounded
group-local dispatch (mesh-TF / t5x style).

Port of `repro.models.moe`.  Tokens are reshaped into G groups of
`group_size`; each group dispatches into per-expert capacity buffers by
one-hot products, so dispatch tensors stay O(tokens * k * cf),
independent of E.  The dispatch, the expert SwiGLU and the combine are
`torch.einsum` products (large batched GEMMs, which the reference
computes outside any Pallas kernel too).  On a device mesh the experts
are sharded as the reference's expert parallelism shards them: each
device runs its own experts on its rows (`_moe_on_shards`) and the
partial outputs and aux terms are summed over the experts' axes.  The
router product goes through `linear`, so a C3-quantized router runs on
the `codebook_matmul` kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as SH
from repro_torch.models.common import (ArchConfig, CodebookWeight,
                                       init_dense, linear)


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


def moe_ffn(x: torch.Tensor, p, cfg: ArchConfig,
            rules: SH.ShardingRules = SH.ShardingRules()):
    """x (B, S, d) -> ((B, S, d), aux load-balancing loss as a 0-d f32).

    The group size is the largest divisor of B * S not above
    `cfg.moe_group_size`; router logits are computed in x's type, then
    widened to f32 for the softmax, as in the reference.
    """
    b, s, d = x.shape
    tokens = b * s
    gs = _group_size(cfg, tokens)
    if SH.is_dtensor(x):
        return _moe_on_shards(x, p, cfg, gs, rules)
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


def _group_size(cfg: ArchConfig, tokens: int) -> int:
    """The dispatch group: the largest divisor of `tokens` not above
    `cfg.moe_group_size`."""
    gs = min(cfg.moe_group_size, tokens)
    while tokens % gs != 0:          # largest divisor <= preferred size
        gs -= 1
    return gs


def _route(router_logits, cfg: ArchConfig, gs: int, first: int, n: int,
           groups: int):
    """The routing of every group's tokens, for the experts [first,
    first + n) of `cfg.n_experts`: (their dispatch and combine (G, S, n,
    C), their terms of the aux loss (n,)); `groups` is the number of
    dispatch groups the aux loss averages over."""
    probs = F.softmax(router_logits.float(), dim=-1)
    cap = capacity(cfg, gs)
    dispatch, combine = top_k_dispatch(probs, cfg.top_k, cap)

    # aux loss (Switch-style load balancing): the mean over groups and
    # experts of density * router_mean, times E^2, split by expert
    e_all = cfg.n_experts
    density = dispatch.sum(dim=(1, 3)) / gs                      # (G, E)
    router_mean = probs.mean(dim=1)                              # (G, E)
    terms = (density * router_mean)[:, first:first + n]
    aux = terms.sum(dim=0) / (groups * e_all) * e_all ** 2
    sl = slice(first, first + n)
    return dispatch[:, :, sl], combine[:, :, sl], aux


def _moe_core(x, router_logits, wi, wg, wo, cfg: ArchConfig, gs: int,
              first: int, groups: int):
    """`moe_ffn` over the experts [first, first + len(wi)) of
    `cfg.n_experts`: (their part of the combined outputs (B, S, d), their
    terms of the aux loss (E_local,))."""
    b, s, d = x.shape
    xg = x.reshape(-1, gs, d)
    dispatch, combine, aux = _route(router_logits, cfg, gs, first,
                                    wi.shape[0], groups)
    xin = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xg)
    h = (torch.einsum("egcd,edf->egcf", xin, wi)
         * F.silu(torch.einsum("egcd,edf->egcf", xin, wg)))
    out_e = torch.einsum("egcf,efd->egcd", h, wo)
    out = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), out_e)
    return out.reshape(b, s, d), aux


def _moe_on_shards(x, p, cfg: ArchConfig, gs: int, rules: SH.ShardingRules):
    """Expert parallelism on a mesh: each device routes all tokens of its
    rows of the batch (the router replicated; a C3 router as its indexes
    and codebook, multiplied on the device's codebook kernel) and runs
    only its own experts (the expert stacks' "experts" axis); the
    outputs and aux terms of the experts are summed over the experts'
    axes (DTensor's reduction of a stacked leading dim).  When a
    dispatch group spans more rows than a batch shard holds (decode: one
    group of every row), every device routes every row and the experts'
    work is split over the stacks' "embed" axes instead
    (`_moe_straddling`).  DTensor's rules for the dispatch einsums fail
    in the backward."""
    mesh = x.device_mesh
    b, s, d = x.shape
    pe = SH.entry_of(p["moe_wi"], 0)
    pb = SH.free_of(SH.spec_for((b,), ("batch",), mesh, rules)[0], pe)
    n_b = SH._axis_size(SH.mesh_sizes(mesh), pb) if pb else 1
    n_e = p["moe_wi"].to_local().shape[0]
    first = SH.shard_index(mesh, pe) * n_e if pe else 0
    groups = b * s // gs
    if (b // n_b * s) % gs:     # a group straddles the batch shards
        return _moe_straddling(x, p, cfg, gs, pe, first, n_e, groups)
    routers, r_specs, router_of = _router_leaves(p["router"])

    def local(x, *args):
        r = router_of(*args[:-3])
        wi, wg, wo = args[-3:]
        out, aux = _moe_core(x, linear(x.reshape(-1, gs, d), r), wi, wg, wo,
                             cfg, gs, first, groups)
        return out[None], aux.sum().reshape(1, 1)

    w = SH.P(pe, None, None)
    out, aux = SH.on_shards(local, mesh, (x, *routers, p["moe_wi"],
                                          p["moe_wg"], p["moe_wo"]),
                            (SH.P(pb, None, None), *r_specs, w, w, w),
                            (SH.P(pe, pb, None, None), SH.P(pe, pb)))
    return out.sum(dim=0), aux.sum()


def _router_leaves(router):
    """The router as `on_shards` arguments, replicated (a C3 router as
    its indexes and codebook, multiplied on the device's codebook
    kernel): (leaves, their specs, the router of the local leaves)."""
    if isinstance(router, CodebookWeight):
        return ((router.idx, router.cb), (SH.P(None, None), SH.P(None)),
                lambda idx, cb: CodebookWeight(idx, cb, router.packed))
    return (router,), (SH.P(None, None),), lambda w: w


def _moe_straddling(x, p, cfg: ArchConfig, gs: int, pe, first: int,
                    n_e: int, groups: int):
    """`_moe_on_shards` when a dispatch group spans the batch shards.
    Every device routes every row (the one-device routing, on whole
    groups) for its experts, then does its share of their work along the
    axes of the stacks' "embed" dim (pd), which keep their
    ("experts", "embed", "mlp") layout, as the reference's layout splits
    that work over "data": the dispatched rows' d-slice times moe_wi's
    and moe_wg's (partial sums over pd, reduced before the SwiGLU), then
    the SwiGLU times moe_wo's d-columns and the combine.  The partial
    sums are taken in f32 and rounded to x's type once, after their
    reduction, as the one-device product rounds its f32 accumulation
    once.  No stack is gathered; the output, its d split over pd, is
    laid out as `x` (an all-to-all where pd are the batch axes).  Three
    regions, so that the routing's gradient is counted once over pd."""
    mesh = x.device_mesh
    b, s, d = x.shape
    pd = SH.free_of(SH.nontrivial(SH.entry_of(p["moe_wi"], 1), mesh), pe)
    xr = x.redistribute(mesh, SH.placements(SH.P(None, None, None), mesh))
    routers, r_specs, router_of = _router_leaves(p["router"])

    def route(x, *args):
        dispatch, combine, aux = _route(
            linear(x.reshape(-1, gs, d), router_of(*args)), cfg, gs, first,
            n_e, groups)
        return dispatch, combine, aux.sum().reshape(1, 1)

    def experts_in(x, dispatch, wi, wg):
        xin = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype),
                           x.reshape(-1, gs, x.shape[-1])).float()
        return (torch.einsum("egcd,edf->egcf", xin, wi.float())[None],
                torch.einsum("egcd,edf->egcf", xin, wg.float())[None])

    def experts_out(hi, hg, combine, wo):
        hi, hg = hi.to(wo.dtype), hg.to(wo.dtype)
        h = hi * F.silu(hg)
        out_e = torch.einsum("egcf,efd->egcd", h, wo)
        out = torch.einsum("gsec,egcd->gsd", combine.to(h.dtype), out_e)
        return out.reshape(b, s, -1)[None]

    e_spec = SH.P(None, None, pe, None)
    dispatch, combine, aux = SH.on_shards(
        route, mesh, (xr, *routers), (SH.P(None, None, None), *r_specs),
        (e_spec, e_spec, SH.P(pe, None)))
    w_in, parts = SH.P(pe, pd, None), SH.P(pd, pe, None, None, None)
    hi, hg = SH.on_shards(
        experts_in, mesh, (xr, dispatch, p["moe_wi"], p["moe_wg"]),
        (SH.P(None, None, pd), e_spec, w_in, w_in), (parts, parts))
    h_spec = SH.P(pe, None, None, None)
    out = SH.on_shards(experts_out, mesh,
                       (hi.sum(dim=0), hg.sum(dim=0), combine, p["moe_wo"]),
                       (h_spec, h_spec, e_spec, SH.P(pe, None, pd)),
                       SH.P(pe, None, None, pd)).sum(dim=0)
    want = [xp if isinstance(xp, SH.Shard) else op
            for xp, op in zip(x.placements, out.placements)]
    return out.redistribute(mesh, want), aux.sum()
