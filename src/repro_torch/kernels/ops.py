"""Public entry points of the port's kernels: leading dims, padding where a
kernel needs it, and the codebook matmul's gradient.

Port of `repro.kernels.ops`.  The device policy takes the place of the
reference's `interpret` switch: CUDA tensors launch the kernel or raise,
CPU tensors run its plain version, any other device raises; nothing falls
back.

The port's zspe, codebook and LIF kernels take shapes that are not block
multiples, so their entry points do not pad; padding would change no
output (the zspe counters count the missing part of an edge tile as
padding, as the reference's padded call does).  `fused_timestep` pads as
the reference does: its kernel takes whole 16-spike words.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import zspe as Z
from repro_torch.core.quant import gather_index
from repro_torch.kernels import codebook_matmul as _cbm
from repro_torch.kernels import fused_timestep as _fused
from repro_torch.kernels import lif_update as _lif
from repro_torch.kernels import zspe_spmm as _zspe


def _pad_to(x: torch.Tensor, mults: tuple[int, ...], value=0) -> torch.Tensor:
    pads = []
    for dim, m in zip(x.shape, mults):
        rem = (-dim) % m
        pads.append((0, rem))
    if all(p == (0, 0) for p in pads):
        return x
    return F.pad(x, [p for pair in reversed(pads) for p in pair],
                 value=value)


def _pick_block(m: int, k: int, n: int) -> tuple[int, int, int]:
    """MXU-aligned blocks, shrunk for small problems (tests / smoke nets)."""
    def pick(d, pref):
        for c in (pref, 256, 128, 64, 32, 16, 8):
            if c <= pref and d >= c:
                return c
        return 8
    return (pick(m, 128), pick(k, 128), pick(n, 128))


# ---------------------------------------------------------------------------
# codebook matmul
# ---------------------------------------------------------------------------

def _gather_weights(idx: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """codebook[idx] by JAX's gather rule: a negative index wraps by +L,
    then clamps into [0, L - 1] (src/repro/kernels/ops.py:110-111)."""
    return codebook[gather_index(idx, codebook.shape[0])]


class _CodebookMatmul(torch.autograd.Function):
    """Forward by the kernel; backward in plain torch, as the reference's
    custom VJP (`_cbm_bwd`) is jnp outside any kernel.  The forward gives
    0 for an index outside [0, L), as the Pallas kernel does; the
    reference's backward gathers instead, so gx does too."""

    @staticmethod
    def forward(ctx, x, idx, codebook):
        ctx.save_for_backward(x, idx, codebook)
        k = x.shape[-1]
        n = idx.shape[-1]
        out = _cbm.codebook_matmul(x.reshape(-1, k).contiguous(),
                                   idx.contiguous(),
                                   codebook.to(torch.float32).contiguous())
        return out.reshape(*x.shape[:-1], n)

    @staticmethod
    def backward(ctx, g):
        x, idx, codebook = ctx.saved_tensors
        k, n = idx.shape
        gx = gcb = None
        if ctx.needs_input_grad[0]:
            w = _gather_weights(idx, codebook).to(torch.float32)
            gx = (g @ w.t()).to(x.dtype)
        if ctx.needs_input_grad[2]:
            # dL/dcb[l] = sum over positions with idx == l of (x^T g); the
            # reference's (K, N, L) one-hot would be 606 MB at the paper's
            # first layer, so scatter-add the (K, N) product instead
            xtg = (x.reshape(-1, k).to(torch.float32).t()
                   @ g.reshape(-1, n).to(torch.float32)).flatten()
            n_levels = codebook.shape[0]
            ix = idx.long().flatten()
            ok = (ix >= 0) & (ix < n_levels)
            gcb = torch.zeros(n_levels, dtype=torch.float32, device=g.device)
            gcb.index_add_(0, ix.clamp(0, n_levels - 1),
                           torch.where(ok, xtg, torch.zeros_like(xtg)))
            gcb = gcb.to(codebook.dtype)
        return gx, None, gcb


def codebook_matmul(x: torch.Tensor, idx: torch.Tensor,
                    codebook: torch.Tensor) -> torch.Tensor:
    """x (..., K) f32 or bf16 @ codebook[idx (K, N) int8] -> (..., N) f32,
    codebook (L,) with L <= 16; differentiable in x and codebook."""
    return _CodebookMatmul.apply(x, idx, codebook)


# ---------------------------------------------------------------------------
# zero-skip spike matmul
# ---------------------------------------------------------------------------

def zspe_spmm(spikes: torch.Tensor, weights: torch.Tensor,
              with_stats: bool = False):
    """spikes (..., K) {0,1} f32 or int8 x weights (K, N) f32 -> (..., N).

    with_stats=True additionally returns the skipped-tile counters used to
    drive the energy model with measured skip rates: (ceil(M/bm),
    ceil(N/bn)) int32 at the block `_pick_block(M, K, N)`, M the product of
    the leading dims.
    """
    k = spikes.shape[-1]
    n = weights.shape[-1]
    s2 = spikes.reshape(-1, k).contiguous()
    out, skipped = _zspe.zspe_spmm(s2, weights.contiguous(),
                                   block=_pick_block(s2.shape[0], k, n))
    out = out.reshape(*spikes.shape[:-1], n)
    if with_stats:
        return out, skipped
    return out


# ---------------------------------------------------------------------------
# fused LIF update
# ---------------------------------------------------------------------------

def lif_update(v, elapsed, current, *, threshold=1.0, leak=0.9, reset=0.0):
    """(..., N) fused partial-update LIF step -> (v', elapsed', spikes,
    updated int8), each of v's shape."""
    n = v.shape[-1]
    outs = _lif.lif_update(v.reshape(-1, n).contiguous(),
                           elapsed.reshape(-1, n).contiguous(),
                           current.reshape(-1, n).contiguous(),
                           threshold=threshold, leak=leak, reset=reset)
    return tuple(o.reshape(v.shape) for o in outs)


# ---------------------------------------------------------------------------
# fused ZSPE -> dequant -> LIF timestep
# ---------------------------------------------------------------------------

def fused_timestep(spikes, weights, v, elapsed, *, codebook=None,
                   threshold=1.0, leak=0.9, reset=0.0,
                   partial_update: bool = True,
                   block: tuple[int, int] | None = None):
    """One fused layer-timestep with arbitrary (M, K, N) shapes.

    `spikes` is (M, K) {0,1}, packed to uint16 words here (the engine
    keeps trains packed and calls the kernel directly).  `weights` is
    either a dense (K, N) f32 matrix or, with `codebook` given as an
    (n_levels, N) per-column level table, a (K, N) int8 index matrix.
    Padding (K to the 16-spike word, M/N to `block` multiples) is applied
    and cropped here; padded spike bits are zero so counters and currents
    are unaffected.  v and elapsed are not written.

    Returns (v', elapsed', spikes_out, touched, nnz_rows, empty_words)
    with `empty_words` counting only the ceil(K/16) real spike words.
    """
    m, k = spikes.shape
    n = v.shape[-1]
    kw = Z.spike_word_count(k)
    packed = Z.pack_spike_words(spikes.to(torch.float32))
    kp = kw * Z.SPIKE_WORD_BITS

    bm, bn = (m, n) if block is None else block
    packed = _pad_to(packed, (bm, kw))
    vp = _pad_to(v, (bm, bn)).clone(memory_format=torch.contiguous_format)
    ep = _pad_to(elapsed, (bm, bn)).clone(
        memory_format=torch.contiguous_format)
    lif = dict(threshold=threshold, leak=leak, reset=reset,
               partial_update=partial_update)
    if codebook is not None:
        w0 = _pad_to(weights.to(torch.int8), (kp, bn)).contiguous()
        cbw = _pad_to(codebook.to(torch.float32), (1, bn)).contiguous()
        outs = _fused.fused_timestep_codebook(packed, w0, cbw, vp, ep, **lif)
    else:
        w0 = _pad_to(weights.to(torch.float32), (kp, bn)).contiguous()
        outs = _fused.fused_timestep_dense(packed, w0, vp, ep, **lif)
    vo, eo, sp, tc, nnz, ew = outs
    return (vo[:m, :n], eo[:m, :n], sp[:m, :n], tc[:m, :n], nnz[:m, 0],
            ew[:m, 0])
