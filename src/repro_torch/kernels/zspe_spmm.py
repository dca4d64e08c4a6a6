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
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_operands, launch

launches = {"zspe_spmm": 0}

MAX_K = 32768        # the kernel stages a row's (k, value) list in shared
MAX_M = 65535        # one grid row per spike row

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I] + [_P] * 6 + [_I] * 6 + [_P]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _tiles(d: int, b: int) -> int:
    return -(-d // b)


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
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    skipped = torch.empty((_tiles(m, bm), _tiles(n, bn)), dtype=torch.int32,
                          device=dev)
    klist = torch.empty((m, k), dtype=torch.int16, device=dev)
    nnz = torch.empty(m, dtype=torch.int32, device=dev)
    occupied = torch.empty((_tiles(m, bm), _tiles(k, bk)), dtype=torch.int32,
                           device=dev)
    launch("zspe_spmm", "zspe_spmm_launch", _ARGTYPES, spikes.data_ptr(),
           int(spikes.dtype == torch.int8), weights.data_ptr(),
           out.data_ptr(), skipped.data_ptr(), klist.data_ptr(),
           nnz.data_ptr(), occupied.data_ptr(), m, k, n, bm, bk, bn,
           torch.cuda.current_stream(dev).cuda_stream)
    launches["zspe_spmm"] += 1
    return out, skipped
