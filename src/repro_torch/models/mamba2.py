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
from repro_torch.models.common import (ArchConfig, CodebookWeight, columns,
                                       divided_axis, gather_codebook,
                                       gather_rows, init_dense, init_ones,
                                       linear, relaid, rms_norm, weight_spec)


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


def _widths(cfg: ArchConfig) -> list:
    """The widths of in_proj's pieces z, x, B, C and dt."""
    d_in, nh, n, _ = dims(cfg)
    return [d_in, d_in, n, n, nh]


def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    return torch.split(zxbcdt, _widths(cfg), dim=-1)


def _in_proj(x, w, cfg: ArchConfig, candidates):
    """in_proj's pieces (z, xin, B, C, dt): the product split after it.
    On a mesh, one product per piece (`_in_proj_pieces`) where the axis
    the heads lie on would otherwise see the whole output gathered (the
    weight's columns split there, and the rows a device multiplies
    outnumber the weight rows the pieces gather: zamba2's prefill), or
    where the first free axis of `candidates` would repeat the whole
    product on each of its devices (`common.divided_axis`: mamba2-130m's
    decode, its 24 heads unsplit, on the axis its state is split on)."""
    if SH.is_dtensor(x):
        axis = _piece_axis(x, w, candidates)
        if axis is not None:
            return _in_proj_pieces(x, w, cfg, axis)
    return _split_proj(linear(x, w), cfg)


def _piece_axis(x, w, candidates):
    """The mesh axis `_in_proj` splits each piece's columns on, or None
    for the product whole and split after.  Where the weight's columns
    lie on an axis, gathering the output there moves rows x N per
    device, re-laying the pieces' weights K / |rows' axes| x N (the
    columns gathered) plus K x N / |axis| (each piece's rows gathered):
    the pieces where the rows outnumber those, in a forward that takes
    no gradient (prefill).  A training step keeps the gathered output:
    its dry-run cells' collective and temp bytes lie within 0.5-2x of the
    reference's that way, and the pieces would take them below (ROADMAP
    Queue 3, zamba2-2.7b train_4k)."""
    mesh = x.device_mesh
    pk, pn = weight_spec(w, mesh)
    pn = SH.nontrivial(pn, mesh)
    if pn is None:
        return divided_axis(x, w, candidates)
    if not isinstance(pn, str) or (torch.is_grad_enabled() and (
            x.requires_grad or getattr(w, "requires_grad", False))):
        return None
    sizes = SH.mesh_sizes(mesh)
    k = x.shape[-1]
    rows = x.numel() // k
    for name, pl in zip(mesh.mesh_dim_names, x.placements):
        if pl.is_shard() and pl.dim < x.ndim - 1 and name != pn:
            rows //= sizes[name]
    moved = k // (1 if pk is None else SH._axis_size(sizes, pk)) + \
        k // sizes[pn]
    return pn if rows > moved else None


def _in_proj_pieces(x, w, cfg: ArchConfig, axis: str):
    """(z, xin, B, C, dt), each x @ its columns of in_proj, the piece's
    columns split on `axis` where its width divides (the heads' layout
    of z, x and dt, which the scan and the gate read), else whole: the
    weight's own column split gathered once, each piece's rows gathered
    where x's rows need them whole (FSDP), x's sequence gathered once for
    all of them (`gather_rows`)."""
    mesh = x.device_mesh
    n = SH.mesh_sizes(mesh)[axis]
    pk = weight_spec(w, mesh)[0]
    w = relaid(w, SH.P(pk, None), mesh)
    step = 2 if isinstance(w, CodebookWeight) and w.packed else 1
    pieces, a = [], 0
    for width in _widths(cfg):
        pn = axis if (width // step) % n == 0 else None
        pieces.append(relaid(columns(w, a, a + width), SH.P(None, pn), mesh))
        a += width
    xs = gather_rows(x, *pieces)
    return tuple(linear(xi, wi) for xi, wi in zip(xs, pieces))


def _conv_weight(w) -> torch.Tensor:
    """The conv kernel (CH, K) as a tensor: a C3 leaf's `cb[idx]` (its
    codebook is already rounded to the serving type)."""
    if isinstance(w, CodebookWeight):
        return gather_codebook(w)
    return w


def _conv_on_shards(xbc, w, b, rules: SH.ShardingRules):
    """The causal conv on a mesh: each device convolves its rows of the
    batch and its channels (all of them, or, the sequence whole, those
    xbc's channels are split on) with their slice of the kernel
    (DTensor's convolution backward cannot take a replicated kernel).  A
    sequence split across devices stays split: each device convolves
    its own positions, all channels, after the previous shard's last
    K - 1 raw rows (`_shard_tails`, zeros before the first shard), as
    the reference's layout convolves a sequence-parallel input."""
    mesh = xbc.device_mesh
    pb = SH.spec_for((xbc.shape[0],), ("batch",), mesh, rules)[0]
    pc = SH.nontrivial(SH.entry_of(xbc, 2), mesh)
    k = w.shape[-1]
    ps = _seq_split(xbc, k - 1)
    if ps is None:
        return SH.on_shards(_conv_rows, mesh, (xbc, w, b),
                            (SH.P(pb, None, pc), SH.P(pc, None),
                             SH.P(pc)), SH.P(pb, None, pc))
    index = SH.shard_index(mesh, ps)

    def local(x, tails, w, b):
        # the previous shard's tail, zeros on the first: selected from
        # one tensor, so every device's gradient reaches every tail (and
        # all run the same collectives in the backward)
        before = torch.cat([torch.zeros_like(tails[:1]), tails[:-1]])
        return _conv_rows(x, w, b, before[index])

    return SH.on_shards(local, mesh, (xbc, _shard_tails(xbc, k - 1), w, b),
                        (SH.P(pb, ps, None), SH.P(None, pb, None, None),
                         SH.P(None, None), SH.P(None)), SH.P(pb, ps, None))


def _channels_split(t) -> bool:
    """Whether DTensor t (B, S, CH)'s channels lie split across devices
    (in_proj's pieces laid out by the heads, `_in_proj_pieces`)."""
    return SH.is_dtensor(t) and SH.nontrivial(SH.entry_of(t, 2),
                                              t.device_mesh) is not None


def _whole_channels(t):
    """t (B, S, CH) with its channels whole on every device: a DTensor
    whose channels are split gathered there; anything else as it is."""
    if not _channels_split(t):
        return t
    spec = SH.spec_of(t.placements, 3, t.device_mesh)
    return t.redistribute(t.device_mesh,
                          SH.placements(SH.P(*spec[:2], None), t.device_mesh))


def _conv_pieces(raw, w, b, rules: SH.ShardingRules):
    """The causal conv of in_proj's raw x, B and C pieces (DTensors whose
    channels `_in_proj_pieces` laid out apart): the conv is depthwise, so
    each piece is convolved on its own channels, laid out as they are,
    with its rows of the kernel and bias (gathered whole, then each
    piece's rows laid out as its channels)."""
    mesh = raw[0].device_mesh
    w = relaid(_conv_weight(w), SH.P(None, None), mesh)
    b = relaid(b, SH.P(None), mesh)
    out, a = [], 0
    for t in raw:
        pc = SH.entry_of(t, 2)
        c = t.shape[-1]
        out.append(_conv_on_shards(
            t, relaid(w[a:a + c], SH.P(pc, None), mesh),
            relaid(b[a:a + c], SH.P(pc), mesh), rules))
        a += c
    return tuple(out)


def _seq_split(x, rows: int):
    """The mesh axes DTensor x (B, S, ...)'s sequence is split on, when
    they hold more than one device and leave each at least `rows`
    positions; else None."""
    ps = SH.nontrivial(SH.entry_of(x, 1), x.device_mesh)
    if ps is None or x.shape[1] // SH._axis_size(
            SH.mesh_sizes(x.device_mesh), ps) < rows:
        return None
    return ps


def _shard_tails(x, rows: int):
    """The last `rows` positions of each device's shard of DTensor x
    (B, S, CH), its sequence split on `_seq_split(x, rows)`: a DTensor
    (n, B, rows, CH) whose dim 0, the shards in order, lies on the
    sequence's axes (gathering it moves only these rows)."""
    mesh = x.device_mesh
    pb, ps = SH.entry_of(x, 0), SH.entry_of(x, 1)
    return SH.on_shards(lambda t: t[:, t.shape[1] - rows:][None], mesh,
                        (x,), (SH.P(pb, ps, None),),
                        SH.P(ps, pb, None, None))


def _causal_conv_train(xbc: torch.Tensor, w, b: torch.Tensor,
                       rules: SH.ShardingRules = SH.ShardingRules()
                       ) -> torch.Tensor:
    """Depthwise causal conv, (B, S, CH) with kernel (CH, K): a
    cross-correlation over K - 1 zeros of left pad, in x's type."""
    w = _conv_weight(w)
    if SH.is_dtensor(xbc):
        return _conv_on_shards(xbc, w, b, rules)
    return _conv_rows(xbc, w, b)


def _conv_rows(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               halo: torch.Tensor | None = None) -> torch.Tensor:
    """`_causal_conv_train` of plain tensors, the K - 1 rows before the
    first taken from `halo` (B, K - 1, CH) instead of zeros."""
    k = w.shape[-1]
    pad = (F.pad(xbc, (0, 0, k - 1, 0)) if halo is None
           else torch.cat([halo, xbc], dim=1)).transpose(1, 2)
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
    # masked before the exp, not after: above the diagonal diff is a sum
    # of -dt·A, which overflows exp in a long chunk (dt·A near -2 a step
    # reaches +500 in 256 steps), and the gradient of where(m, exp(diff),
    # 0) is 0 · inf = NaN there; exp(-inf) is 0, the same forward values
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              torch.full((), float("-inf"),
                                         device=x.device)))
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


def _decay_from_start(dt_act, A, chunk: int):
    """(b, s, h) f32: how much a state entering step 0 of dt_act (b, s,
    h) has decayed by each step: exp of dt·A summed within each chunk,
    times the decays of the chunks before, as `ssd_chunked` carries it."""
    b, s, h = dt_act.shape
    dA_cum = torch.cumsum(dt_act.reshape(b, s // chunk, chunk, h) * A,
                          dim=2)
    chunk_decay = torch.exp(dA_cum[:, :, -1])             # (b,nc,h)
    before = torch.cumprod(torch.cat([torch.ones_like(chunk_decay[:, :1]),
                                      chunk_decay[:, :-1]], dim=1), dim=1)
    return (torch.exp(dA_cum) * before[:, :, None]).reshape(b, s, h)


def _scan_on_shards(rules: SH.ShardingRules, hp: int, chunk: int, xin, dt,
                    B, C, A_log, dt_bias, D):
    """`_scan` on a mesh: each device scans its rows of the batch and its
    SSD heads (the heads on the axis the layer's `A_log` is sharded on,
    else all of them), with B and C whole: the scan's hundreds of small
    ops then run on plain local tensors, not through DTensor's layout
    propagation (which also cannot split (..., heads * hp) once it has
    sharded it off the heads).  With the heads unsplit and the sequence
    split into whole chunks, `_scan_by_chunks`."""
    mesh = xin.device_mesh
    ph = SH.entry_of(A_log, 0) if SH.is_dtensor(A_log) else None
    pb = SH.free_of(SH.spec_for((xin.shape[0],), ("batch",), mesh,
                                rules)[0], ph)
    args = (xin, dt, B, C, A_log, dt_bias, D)
    ps = _seq_split(xin, chunk) if ph is None else None
    if ps is not None and (xin.shape[1] // SH._axis_size(
            SH.mesh_sizes(mesh), ps)) % chunk == 0:
        return _scan_by_chunks(mesh, pb, ps, hp, chunk, *args)
    rows = SH.P(pb, None, ph)
    heads = SH.P(ph)
    scan = functools.partial(_scan, hp=hp, chunk=chunk)
    return SH.on_shards(scan, mesh, args,
                        (rows, rows, SH.P(pb, None, None),
                         SH.P(pb, None, None), heads, heads, heads),
                        (rows, SH.P(pb, ph, None, None)))


def _scan_by_chunks(mesh, pb, ps, hp: int, chunk: int, xin, dt, B, C, A_log,
                    dt_bias, D):
    """`_scan` with the sequence split on `ps` (whole chunks a device),
    as the reference's layout keeps a sequence-parallel scan: each device
    scans its own chunks from a zero state (the intra-chunk term, the
    chunk end-states, the inter-chunk term among its chunks) and returns
    its shard's end state and total decay; these (b, h, n, p) and (b, h)
    summaries are gathered over `ps`, each device folds in the shards
    before its own, in order, to the state entering its first chunk, and
    adds that state's decayed contribution to its rows.  The final state
    is the state after every shard, kept by the last.  The same
    recurrence as the one-device scan, reassociated."""
    index = SH.shard_index(mesh, ps)
    rows = SH.P(pb, ps, None)

    def own_chunks(xin, dt, B, C, A_log, dt_bias, D):
        y, end = _scan(xin, dt, B, C, A_log, dt_bias, D, hp, chunk)
        decay = _decay_from_start(F.softplus(dt.float() + dt_bias),
                                  -torch.exp(A_log.float()), chunk)
        return y, decay, end[None], decay[:, -1][None]

    y, decay, ends, totals = SH.on_shards(
        own_chunks, mesh, (xin, dt, B, C, A_log, dt_bias, D),
        (rows, rows, rows, rows, SH.P(None), SH.P(None), SH.P(None)),
        (rows, rows, SH.P(ps, pb, None, None, None), SH.P(ps, pb, None)))

    def fold(y, decay, C, ends, totals):
        b, s, _ = y.shape
        states = [torch.zeros_like(ends[0])]
        for j in range(ends.shape[0]):
            states.append(states[-1] * totals[j][..., None, None] + ends[j])
        # the state entering this shard, selected from one tensor, so
        # every device's gradient reaches every summary (and all run
        # the same collectives in the backward)
        entering = torch.stack(states[:-1])[index]
        carried = (C.float()[:, None] @ entering).permute(0, 2, 1, 3)
        carried = carried * decay[..., None]                # (b, s, h, p)
        last = torch.tensor(index == n - 1, device=y.device)
        final = torch.where(last, states[-1], torch.zeros_like(states[-1]))
        return y + carried.reshape(b, s, -1), final[None]

    # the final state is the last shard's (zeros elsewhere, summed over
    # the shards: one reduction of a state, not a gather of every
    # shard's), so its gradient is counted once
    n = SH._axis_size(SH.mesh_sizes(mesh), ps)
    y, final = SH.on_shards(
        fold, mesh, (y, decay, C, ends, totals),
        (rows, rows, rows, SH.P(None, pb, None, None, None),
         SH.P(None, pb, None)), (rows, SH.P(ps, pb, None, None, None)))
    return y, final.sum(dim=0).redistribute(
        mesh, SH.placements(SH.P(pb, None, None, None), mesh))


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
    z, xin, B, C, dt = _in_proj(x, p["in_proj"], cfg, rules.get("heads"))
    if _channels_split(xin):
        raw = (xin, B, C)
        xin, B, C = _conv_pieces(raw, p["conv_w"], p["conv_b"], rules)
    else:
        raw = torch.cat([xin, B, C], dim=-1)
        xbc = _causal_conv_train(raw, p["conv_w"], p["conv_b"], rules)
        xin, B, C = torch.split(xbc, [d_in, n, n], dim=-1)
    args = (xin, dt, B, C, p["A_log"], p["dt_bias"], p["D"])
    if SH.is_dtensor(xin):
        y, final = _scan_on_shards(rules, hp, cfg.ssm_chunk, *args)
    else:
        y, final = _scan(*args, hp, cfg.ssm_chunk)
    y = y.to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    out = linear(y, _rows_as(p["out_proj"], y))
    if not return_cache:
        return out
    tail = (torch.cat([_whole_channels(_conv_window(t, k - 1)) for t in raw],
                      dim=-1) if isinstance(raw, tuple)
            else _conv_window(raw, k - 1))               # raw conv window
    if cache is None:
        return out, SSMCache(conv=tail, state=final)
    cache.conv.copy_(tail)
    cache.state.copy_(final)
    return out, cache


def _conv_window(x, rows: int):
    """The last `rows` positions of x (B, S, CH): of a DTensor whose
    sequence is split, the last shard's tail (`_shard_tails`), not a
    gather of the sequence."""
    if SH.is_dtensor(x) and _seq_split(x, rows) is not None:
        return _shard_tails(x, rows)[-1]
    return x[:, x.shape[1] - rows:, :]


def mamba2_decode(x, p, cfg: ArchConfig, cache: SSMCache):
    """One-token step.  x (B, 1, d) -> (B, 1, d), new cache.  On a mesh
    whose axis the state is split on (its heads, or its N where the
    heads do not divide it) would repeat every product (mamba2-130m's,
    its weights' heads unsplit), in_proj runs on each device's columns of
    each piece (`_in_proj_pieces`), x, B and C are gathered for the conv
    window, the gate runs on z's columns and out_proj on the matching
    rows (`_rows_as`), a partial sum over that axis."""
    d_in, _, n, hp = dims(cfg)
    state_axes = ([SH.entry_of(cache.state, d) for d in (1, 2)]
                  if SH.is_dtensor(cache.state) else [])
    z, xin, B, C, dt = _in_proj(x, p["in_proj"], cfg, state_axes)
    raw_xbc = torch.cat([_whole_channels(t) for t in (xin, B, C)],
                        dim=-1)                           # (B, 1, CH)
    xbc, new_conv = _causal_conv_step(raw_xbc, cache.conv, p["conv_w"],
                                      p["conv_b"])
    xin, B, C = torch.split(xbc, [d_in, n, n], dim=-1)
    args = (xin, dt, B, C, p["A_log"], p["dt_bias"], p["D"], cache.state)
    if SH.is_dtensor(cache.state) and SH.entry_of(cache.state, 1) is not None:
        y, state = _ssm_step_on_shards(hp, *args)
    elif _channels_split(z):
        y, state = _ssm_step_on_state_shards(hp, *args)
    else:
        y, state = _ssm_step(*args, hp)
    y = y.to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    out = linear(y, _rows_as(p["out_proj"], y))
    return out, SSMCache(conv=new_conv, state=state)


def _rows_as(w, y):
    """out_proj laid out for its input y (B, S, K): where y's K lies on
    an axis that w's rows do not (z's columns, `_in_proj_pieces`), w's
    rows split alike and its columns gathered, so each device's product
    is its partial sum of every output; else w as it is."""
    if not SH.is_dtensor(y):
        return w
    mesh = y.device_mesh
    pk = SH.nontrivial(SH.entry_of(y, y.ndim - 1), mesh)
    if pk is None or weight_spec(w, mesh)[0] == pk:
        return w
    return relaid(w, SH.P(pk, None), mesh)


def _ssm_step(xin, dt, B, C, A_log, dt_bias, D, state, hp: int):
    """The recurrence of one decode step: xin (b, 1, h * hp), dt (b, 1,
    h), B / C (b, 1, n), the state (b, h, n, hp) -> (y (b, 1, h * hp) f32
    with the D skip, the new f32 state)."""
    b = xin.shape[0]
    nh = xin.shape[-1] // hp
    A = -torch.exp(A_log.float())                         # (h,)
    dt_act = F.softplus(dt[:, 0].float() + dt_bias)       # (B, h)
    xh = xin[:, 0].reshape(b, nh, hp).float()
    Bv = B[:, 0].float()                                  # (B, n)
    Cv = C[:, 0].float()
    decay = torch.exp(dt_act * A)                         # (B, h)
    upd = (dt_act[:, :, None] * Bv[:, None, :])[..., None] * xh[:, :, None]
    state = state.float() * decay[..., None, None] + upd  # (B,h,n,p)
    y = (Cv[:, None, None, :] @ state)[:, :, 0]           # (B, h, p)
    y = y + D[None, :, None] * xh
    return y.reshape(b, 1, nh * hp), state


def _ssm_step_on_shards(hp: int, xin, dt, B, C, A_log, dt_bias, D, state):
    """`_ssm_step` on each device's heads of a state split over heads
    (`decode_state_spec`: "cache_heads" where they divide the axis): x,
    dt and the per-head weights laid out by the state's heads (a no-op
    where the weights are split alike, as zamba2's are), B and C whole.
    Each device's step reads only its heads' weights and rows; DTensor's
    own rules would fold (B, H) with H split for the state's batched
    product, which torch 2.11's DTensor cannot."""
    mesh = state.device_mesh
    pb, ph = SH.entry_of(state, 0), SH.entry_of(state, 1)
    heads, whole = SH.P(pb, None, ph), SH.P(pb, None, None)
    per_head, st = SH.P(ph), SH.P(pb, ph, None, None)
    return SH.on_shards(functools.partial(_ssm_step, hp=hp), mesh,
                        (xin, dt, B, C, A_log, dt_bias, D, state),
                        (heads, heads, whole, whole, per_head, per_head,
                         per_head, st), (heads, st))


def _ssm_step_on_state_shards(hp: int, xin, dt, B, C, A_log, dt_bias, D,
                              state):
    """`_ssm_step` of a state split over N (`decode_state_spec`'s
    "cache_seq" branch, where the heads do not divide the axis) in a
    decode step divided over that axis (`_in_proj_pieces`): each device
    updates its slice of N from x and dt whole and its slice of B and C;
    its part of y, C's slice times its slice of the state, is a partial
    sum over that axis, summed in f32, and the D skip is added once
    after.  A batch of one row (long_500k) keeps DTensor's own step."""
    mesh = state.device_mesh
    pb, pn = SH.entry_of(state, 0), SH.entry_of(state, 2)
    whole, sliced = SH.P(pb, None, None), SH.P(pb, None, pn)

    def local(xin, dt, B, C, A_log, dt_bias, state):
        y, new = _ssm_step(xin, dt, B, C, A_log, dt_bias,
                           torch.zeros_like(dt_bias), state, hp)
        return y[None], new

    ys, state = SH.on_shards(
        local, mesh, (xin, dt, B, C, A_log, dt_bias, state),
        (whole, whole, sliced, sliced, SH.P(None), SH.P(None),
         SH.P(pb, None, pn, None)),
        (SH.P(pn, pb, None, None), SH.P(pb, None, pn, None)))
    y = ys.sum(dim=0)
    y = y.redistribute(mesh, SH.placements(whole, mesh))
    b = xin.shape[0]
    skip = D[None, :, None] * xin[:, 0].reshape(b, D.shape[0], hp).float()
    return y + skip.reshape(b, 1, -1), state


def init_cache(cfg: ArchConfig, batch: int, dtype, device=None) -> SSMCache:
    d_in, nh, n, hp = dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_channels(cfg)),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, nh, n, hp), dtype=torch.float32,
                          device=device),
    )
