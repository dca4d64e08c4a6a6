"""Zero-skip spike matmul (ZSPE + SPE, paper C1) on Hopper.

Port of `repro.kernels.zspe_spmm` (the Pallas TPU kernel behind
`ops.zspe_spmm`).  Three parts, as in `fused_timestep.py`:

* the CUDA kernel in `csrc/zspe_spmm.cu`, launched on the current stream
  for CUDA tensors;
* its plain version, `zspe_spmm_plain`; the wrapper uses it for CPU
  tensors;
* a launch count (`launches`), raised by one exactly where the kernel is
  launched.

The skip counters are semantics, not speed: for the caller's block
(bm, bk, bn), `skipped[i, j]` counts the K-tiles whose (bm, bk) spike tile
in row-tile i holds no spike, the same for every j.  Unlike the
reference's kernel, this one takes shapes that are not block multiples
and counts the missing part of an edge tile as zero padding, which is
what the reference's padded call (`ops.zspe_spmm`) counts; so no caller
has to pad.

`_plan` sizes a launch: how many blocks of a thread-block cluster split
K between them, so that a one-step call (M = 32) still fills the card
with the kernel's (32, 64) output tiles.
The kernel's two scratch buffers (the counters' bitmap, which starts
zero and is left zero, and the scan's row masks) are
allocated once per device and grown when a call needs more: calls on
one device are ordered by their stream, and calls on two streams of one
device must not overlap.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_operands, launch, library

launches = {"zspe_spmm": 0}

MAX_K = 32768        # the largest K and M the wrapper passes to the
MAX_M = 65535        # kernel; past them it raises
BM, BN = 32, 64      # a block's output tile: a k's row mask is one word
K_GROUP = 32         # a K slice is a multiple of this
MAX_SPLIT = 8        # blocks per cluster (the portable limit)
TARGET_BLOCKS = 128  # about one block for each of the H100's 132 SMs

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _P] + [_I] * 8 + [_P]

_scratch: dict[tuple[torch.device, str], torch.Tensor] = {}


class Plan(NamedTuple):
    """Block r of a tile's cluster sums rows [r k_chunk, (r + 1) k_chunk)
    of K, cut at K; its output tile is (BM, BN)."""
    split: int     # blocks of a cluster sharing one output tile along K
    k_chunk: int   # K rows per block of the cluster, a multiple of K_GROUP


def _plan(m: int, k: int, n: int) -> Plan:
    """The smallest power-of-two split of K (at most MAX_SPLIT, and no
    more than K has groups of K_GROUP) that brings the grid of (BM, BN)
    tiles to TARGET_BLOCKS."""
    tiles = _tiles(m, BM) * _tiles(n, BN)
    groups = max(1, _tiles(k, K_GROUP))
    split = 1
    while (split < MAX_SPLIT and split * 2 <= groups
           and tiles * split < TARGET_BLOCKS):
        split *= 2
    return Plan(split, _tiles(groups, split) * K_GROUP)


def _scratch_for(dev: torch.device, what: str, words: int) -> torch.Tensor:
    """The device's scratch buffer `what` of at least `words` int32
    words, allocated zero."""
    buf = _scratch.get((dev, what))
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 1024), dtype=torch.int32, device=dev)
        _scratch[(dev, what)] = buf
    return buf


def _words(name: str, *args: int) -> int:
    fn = getattr(library("zspe_spmm"), name)
    fn.argtypes = [_I] * len(args)
    fn.restype = ctypes.c_longlong
    return fn(*args)


def _tiles(d: int, b: int) -> int:
    return -(-d // b)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def zspe_spmm_plain(spikes, weights, block):
    """The kernel's function in plain torch: (out (M, N) f32, skipped
    (ceil(M/bm), ceil(N/bn)) int32)."""
    bm, bk, bn = block
    m, k = spikes.shape
    gm, gk = _tiles(m, bm), _tiles(k, bk)
    nz = F.pad((spikes != 0).to(torch.int32), (0, gk * bk - k, 0, gm * bm - m))
    empty = nz.reshape(gm, bm, gk, bk).sum(dim=(1, 3)) == 0
    per_row_tile = empty.sum(dim=1, dtype=torch.int32)
    skipped = per_row_tile[:, None].repeat(1, _tiles(weights.shape[1], bn))
    return ref.zspe_spmm_ref(spikes, weights), skipped


def zspe_spmm(spikes: torch.Tensor, weights: torch.Tensor, *,
              block: tuple[int, int, int]):
    """spikes (M, K) {0,1} f32 or int8 x weights (K, N) f32.

    Returns (out (M, N) f32, skipped (ceil(M/bm), ceil(N/bn)) int32), the
    number of K-tiles whose work was skipped for each output tile.
    """
    if spikes.dim() != 2 or weights.dim() != 2 \
            or spikes.shape[1] != weights.shape[0]:
        raise ValueError(f"zspe_spmm: spikes (M, K) and weights (K, N) "
                         f"expected; got {tuple(spikes.shape)}, "
                         f"{tuple(weights.shape)}")
    bm, bk, bn = (int(b) for b in block)
    if min(bm, bk, bn) <= 0:
        raise ValueError(f"zspe_spmm: block must be positive, got {block}")
    dev = check_operands("zspe_spmm",
                         (spikes, (torch.float32, torch.int8), "spikes"),
                         (weights, torch.float32, "weights"))
    if dev.type == "cpu":
        return zspe_spmm_plain(spikes, weights, (bm, bk, bn))
    m, k = spikes.shape
    n = weights.shape[1]
    if k > MAX_K or m > MAX_M:
        raise ValueError(f"zspe_spmm: the kernel takes K <= {MAX_K} and "
                         f"M <= {MAX_M}; got M={m}, K={k}")
    plan = _plan(m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    gm, gn = _tiles(m, bm), _tiles(n, bn)
    skipped = torch.empty((gm, gn), dtype=torch.int32, device=dev)
    bits = _scratch_for(dev, "bits",
                        _words("zspe_spmm_bits_words", m, k, bm, bk))
    masks = _scratch_for(dev, "masks", _words("zspe_spmm_masks_words", m, k))
    launch("zspe_spmm", "zspe_spmm_launch", _ARGTYPES, spikes.data_ptr(),
           int(spikes.dtype == torch.int8), weights.data_ptr(),
           out.data_ptr(), skipped.data_ptr(), bits.data_ptr(),
           masks.data_ptr(), m, k, n,
           bm, bk, bn, plan.split, plan.k_chunk,
           torch.cuda.current_stream(dev).cuda_stream)
    launches["zspe_spmm"] += 1
    return out, skipped
