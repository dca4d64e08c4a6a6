"""One fused ZSPE -> codebook-dequant -> LIF layer-timestep on Hopper.

Port of `repro.kernels.fused_timestep` (the Pallas TPU kernel behind
`fused_timestep_codebook` and `fused_timestep_dense`).  Each entry point
has three parts:

* the CUDA kernel in `csrc/fused_timestep.cu`, built by `build.py` and
  launched on the current stream for CUDA tensors;
* its plain version, `fused_timestep_plain`, the same function in plain
  torch, expression for expression with the reference's `_unpack_words`,
  `_dequant_columns` and `_lif_tile`; the wrapper uses it for CPU
  tensors, and the tests and `chip_smoke.py` hold the kernel against it;
* a launch count per variant (`launches`), raised by one exactly where
  the kernel is launched, so a run can show that it went through it.

Membrane state is read-modify-write: `v` and `elapsed` are updated in
place on both devices, and the returned v' / elapsed' are those same
tensors (the reference donates the buffers to XLA for the same effect).

An index outside [0, L) adds 0 and touches nothing, as in the
reference's compare-and-select dequant, which it runs on a device.

`_plan` sizes a launch of either variant: the output tile's width, so
that a one-step call (M = 32) still fills the card, and the shared memory
the kernel needs for it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.zspe import SPIKE_WORD_BITS, words_as_int32
from repro_torch.kernels.build import check_operands, launch

launches = {"fused_timestep_codebook": 0, "fused_timestep_dense": 0}

BM = 32              # rows of an output tile: a k's row mask
BNS = (16, 8)        # its widths: two or one n8 tile of the f64 product
TARGET_BLOCKS = 128  # about one block for each of the H100's 132 SMs
MAX_LEVELS = 128     # int8 indexes reach levels 0..127 only
CHUNK_WORDS = 256    # spike words a block lists at once

# csrc/fused_timestep.cu's shared-memory layout: per block (512 threads
# for BN = 8, 256 for wider tiles) the level table ((min(L, 128) + 1) x BN
# f64; codebook only) and a ring of stages of a weight row and its row mask
# per thread (codebook: 8 stages of 16-byte index rows; dense:
# `_dense_stages` stages of f32 rows of 4 BN bytes), which the warps'
# (32, BN) f64 partial tiles and touched masks reuse; then the chunk's
# spike words, row masks, k-list and counts
_CHUNK_BYTES = (BM * (CHUNK_WORDS + 2) * 2 + CHUNK_WORDS * 16 * (4 + 2)
                + CHUNK_WORDS // 2 * 4 * 2 + 2 * BM * 4 + 16)
CODEBOOK_STAGES = 8


def _dense_stages(bn: int) -> int:
    """Ring stages of the dense variant: three at BN 16, so that two blocks
    of 256 threads fit an SM (as two codebook blocks do), else four."""
    return 3 if bn == 16 else 4


class Plan(NamedTuple):
    """A block owns a (BM, bn) output tile over all of K."""
    bn: int        # output columns per block
    smem: int      # shared-memory bytes per block


def _tiles(d: int, b: int) -> int:
    return -(-d // b)


def _block_threads(bn: int) -> int:
    return 512 if bn == 8 else 256


def _smem_bytes(bn: int, n_levels: int | None) -> int:
    """Shared bytes of a block; `n_levels=None` is the dense variant."""
    threads = _block_threads(bn)
    if n_levels is None:
        table, ring = 0, _dense_stages(bn) * threads * (4 * bn + 4)
    else:
        table = (min(n_levels, MAX_LEVELS) + 1) * bn * 8
        ring = CODEBOOK_STAGES * threads * (16 + 4)
    partials = threads // 32 * (BM * bn * 8 + bn * 4)
    return max(table + ring, partials) + _CHUNK_BYTES


def _plan(m: int, n: int, n_levels: int | None) -> Plan:
    """The wider tile, unless it leaves the grid short of TARGET_BLOCKS;
    `n_levels=None` plans the dense variant."""
    wide = _tiles(m, BM) * _tiles(n, BNS[0]) >= TARGET_BLOCKS
    bn = BNS[0] if wide else BNS[1]
    return Plan(bn, _smem_bytes(bn, n_levels))


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _unpack_words(pk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(bm, kw) uint16 -> ((bm, kw*16) f32 {0,1}, (bm,) int32 popcounts)."""
    bm, kw = pk.shape
    shifts = torch.arange(SPIKE_WORD_BITS, dtype=torch.int32, device=pk.device)
    bits = (words_as_int32(pk)[:, :, None] >> shifts) & 1
    s = bits.reshape(bm, kw * SPIKE_WORD_BITS).to(torch.float32)
    nnz = bits.sum(dim=(1, 2), dtype=torch.int32)
    return s, nnz


def _dequant_columns(idx: torch.Tensor, cbw: torch.Tensor) -> torch.Tensor:
    """Expand (K, bn) indexes against per-column level values (L, bn):
    the f32 element `cbw[idx[k, n], n]` where 0 <= idx < L, else 0."""
    # 0 out of range: src/repro/kernels/fused_timestep.py:79-82, the
    # dequant src/repro/kernels/ops.py:207 selects on a device
    ix = idx.long()
    ok = (ix >= 0) & (ix < cbw.shape[0])
    w = torch.gather(cbw, 0, ix.clamp(0, cbw.shape[0] - 1))
    return torch.where(ok, w, torch.zeros_like(w))


def _lif_tile(v, el, cur, tcnt, *, threshold, leak, reset, partial_update):
    """The neuron-updater stage: expression for expression the reference's
    `_lif_tile` (hard reset)."""
    if partial_update:
        touched = tcnt > 0
        pending = el + 1
        decay = torch.where(touched, leak ** pending.to(v.dtype),
                            torch.ones_like(v))
        v_int = v * decay + cur
        v_eff = torch.where(touched, v_int, torch.full_like(v, -torch.inf))
        spikes = ((v_eff - threshold) >= 0.0).to(v.dtype)
        v_new = torch.where(spikes > 0, torch.full_like(v, reset),
                            torch.where(touched, v_int, v))
        el_new = torch.where(touched, torch.zeros_like(pending), pending)
    else:
        v_int = v * leak + cur
        spikes = ((v_int - threshold) >= 0.0).to(v.dtype)
        touched = torch.ones(v.shape, dtype=torch.bool, device=v.device)
        v_new = torch.where(spikes > 0, torch.full_like(v, reset), v_int)
        el_new = torch.zeros_like(el)
    return v_new, el_new, spikes, touched.to(torch.int32)


def fused_timestep_plain(packed, w0, cbw, v, elapsed, *, threshold, leak,
                         reset, partial_update, all_nonzero):
    """The whole batch as one tile, like the reference at `block=None`.

    `cbw=None` selects the dense variant (`w0` is then f32 weights).
    Returns new tensors (v', elapsed', spikes, touched, nnz (M, 1),
    empty words (M, 1)); it does not write `v` or `elapsed`.
    """
    pk = packed
    s, nnz_rows = _unpack_words(pk)
    nnz_col = nnz_rows[:, None]
    ew = (words_as_int32(pk) == 0).sum(dim=1, dtype=torch.int32)[:, None]
    lif = dict(threshold=threshold, leak=leak, reset=reset,
               partial_update=partial_update)
    if int(nnz_rows.sum()) == 0:
        # ZSPE saw only empty words: no synaptic work, no touches; the
        # partial-update bookkeeping (elapsed + 1) or the plain leak runs
        vo, elo, sp, _ = _lif_tile(v, elapsed, torch.zeros_like(v),
                                   torch.zeros_like(elapsed), **lif)
        tc = (torch.zeros_like(elapsed) if partial_update
              else torch.ones_like(elapsed))
        return vo, elo, sp, tc, nnz_col, ew
    w = _dequant_columns(w0, cbw) if cbw is not None else w0
    cur = s @ w
    if all_nonzero:
        tcnt = nnz_col.to(torch.float32).expand(v.shape)
    else:
        tcnt = s @ (w != 0.0).to(torch.float32)
    vo, elo, sp, tc = _lif_tile(v, elapsed, cur, tcnt, **lif)
    return vo, elo, sp, tc, nnz_col, ew


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "fused_timestep_codebook": [_P] * 9 + [_I] * 6 + [_F] * 3
    + [_I, _I, _P],
    "fused_timestep_dense": [_P] * 8 + [_I] * 5 + [_F] * 3
    + [_I, _I, _P],
}


def _check(name, packed, w0, cbw, v, elapsed):
    """Validate what the kernel takes; returns (m, kw, n, device)."""
    if packed.dim() != 2 or v.dim() != 2 or elapsed.shape != v.shape:
        raise ValueError(f"{name}: packed (M, Kw), v and elapsed (M, N) "
                         f"expected; got {tuple(packed.shape)}, "
                         f"{tuple(v.shape)}, {tuple(elapsed.shape)}")
    m, kw = packed.shape
    n = v.shape[1]
    if v.shape[0] != m or w0.shape != (kw * SPIKE_WORD_BITS, n):
        raise ValueError(f"{name}: weights must be ({kw * SPIKE_WORD_BITS}, "
                         f"{n}) for packed {tuple(packed.shape)}, v "
                         f"{tuple(v.shape)}; got {tuple(w0.shape)}")
    want = [(v, torch.float32, "v"), (packed, torch.uint16, "packed"),
            (elapsed, torch.int32, "elapsed"),
            (w0, torch.int8 if cbw is not None else torch.float32,
             "idx" if cbw is not None else "weights")]
    if cbw is not None:
        want.append((cbw, torch.float32, "cbw"))
        if cbw.dim() != 2 or cbw.shape[1] != n:
            raise ValueError(f"{name}: cbw must be (L, {n}); got "
                             f"{tuple(cbw.shape)}")
    dev = check_operands(name, *want)
    return m, kw, n, dev


def _run(name, packed, w0, cbw, v, elapsed, threshold, leak, reset,
         partial_update, all_nonzero):
    m, kw, n, dev = _check(name, packed, w0, cbw, v, elapsed)
    if dev.type == "cpu":
        vo, eo, sp, tc, nnz, ew = fused_timestep_plain(
            packed, w0, cbw, v, elapsed, threshold=threshold, leak=leak,
            reset=reset, partial_update=partial_update,
            all_nonzero=all_nonzero)
        v.copy_(vo)
        elapsed.copy_(eo)
        return v, elapsed, sp, tc, nnz, ew
    spikes = torch.empty_like(v)
    touched = torch.empty_like(elapsed)
    nnz = torch.empty((m, 1), dtype=torch.int32, device=v.device)
    ew = torch.empty((m, 1), dtype=torch.int32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    head = [packed.data_ptr(), w0.data_ptr()]
    if cbw is not None:
        head.append(cbw.data_ptr())
    tail = [v.data_ptr(), elapsed.data_ptr(), spikes.data_ptr(),
            touched.data_ptr(), nnz.data_ptr(), ew.data_ptr(), m, kw, n]
    n_levels = None if cbw is None else int(cbw.shape[0])
    if n_levels is not None:
        tail.append(n_levels)
    tail += _plan(m, n, n_levels)
    tail += [float(threshold), float(leak), float(reset),
             int(bool(partial_update)), int(bool(all_nonzero)), stream]
    launch("fused_timestep", f"{name}_launch", _ARGTYPES[name], *head, *tail)
    launches[name] += 1
    return v, elapsed, spikes, touched, nnz, ew


def fused_timestep_codebook(packed, idx, cbw, v, elapsed, *,
                            threshold: float = 1.0, leak: float = 0.9,
                            reset: float = 0.0, partial_update: bool = True,
                            all_nonzero: bool = False):
    """One fused layer-timestep, codebook-compressed weights.

    packed (M, Kw) uint16 spike words; idx (16*Kw, N) int8 indexes; cbw
    (L, N) f32 per-column level values; v (M, N) f32 and elapsed (M, N)
    int32, both updated in place.  `all_nonzero` states that every real
    weight is nonzero, so touch counts are the row popcounts.

    Returns (v', elapsed', spikes, touched, nnz (M, 1), empty words (M, 1)).
    """
    return _run("fused_timestep_codebook", packed, idx, cbw, v, elapsed,
                threshold, leak, reset, partial_update, all_nonzero)


def fused_timestep_dense(packed, weights, v, elapsed, *,
                         threshold: float = 1.0, leak: float = 0.9,
                         reset: float = 0.0, partial_update: bool = True,
                         all_nonzero: bool = False):
    """Dense-weight variant (float simulators): weights (16*Kw, N) f32,
    otherwise as `fused_timestep_codebook`."""
    return _run("fused_timestep_dense", packed, weights, None, v, elapsed,
                threshold, leak, reset, partial_update, all_nonzero)
