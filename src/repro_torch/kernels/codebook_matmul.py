"""Matmul with on-the-fly codebook dequantization (paper C3) on Hopper.

Port of `repro.kernels.codebook_matmul` (the Pallas TPU kernel behind
`ops.codebook_matmul`'s forward).  Three parts, as in
`fused_timestep.py`:

* the CUDA kernel in `csrc/codebook_matmul.cu`, launched on the current
  stream for CUDA tensors;
* its plain version, `codebook_matmul_plain`; the wrapper uses it for CPU
  tensors;
* a launch count (`launches`), raised by one exactly where the kernel is
  launched.

Dequantization follows the reference's compare-and-select: an index
outside [0, L) contributes 0 (a gather would clamp or fail instead).

`_plan` sizes a launch: the row tile (32 rows when M <= 32, else 64), and
how many blocks of a thread-block cluster split K between them, so that
a one-step call (M = 32) still fills the card.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels.build import check_operands, launch

launches = {"codebook_matmul": 0}

MAX_LEVELS = 16      # the reference's codebook size
BN = 64              # output columns per block
STAGE_K = 32         # K rows per pipeline stage of the kernel
MAX_SPLIT = 8        # blocks per cluster (the portable limit)
TARGET_BLOCKS = 256  # about two blocks for each of the H100's 132 SMs

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _P] + [_I] * 7 + [_P]


class Plan(NamedTuple):
    """Block r of a tile's cluster sums rows [r k_chunk, (r + 1) k_chunk)
    of K, cut at K; its output tile is (bm, BN)."""
    bm: int        # output rows per block
    split: int     # blocks of a cluster sharing one output tile along K
    k_chunk: int   # K rows per block of the cluster, a multiple of STAGE_K


def _plan(m: int, k: int, n: int) -> Plan:
    """Row tile to fit M, then the smallest power-of-two split of K (at
    most MAX_SPLIT, and no more than K has stages) that brings the grid to
    TARGET_BLOCKS."""
    bm = 32 if m <= 32 else 64
    tiles = -(-m // bm) * -(-n // BN)
    stages = max(1, -(-k // STAGE_K))
    split = 1
    while (split < MAX_SPLIT and split * 2 <= stages
           and tiles * split < TARGET_BLOCKS):
        split *= 2
    k_chunk = -(-stages // split) * STAGE_K
    return Plan(bm, split, k_chunk)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def dequantize(idx: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(K, N) indexes -> f32 weights codebook[idx], 0 where idx is outside
    [0, L)."""
    ix = idx.long()
    n_levels = codebook.shape[0]
    ok = (ix >= 0) & (ix < n_levels)
    w = codebook.to(torch.float32)[ix.clamp(0, n_levels - 1)]
    return torch.where(ok, w, torch.zeros_like(w))


def codebook_matmul_plain(x, idx, codebook):
    """The kernel's function in plain torch: f32 (M, N)."""
    return x.to(torch.float32) @ dequantize(idx, codebook)


def codebook_matmul(x: torch.Tensor, idx: torch.Tensor,
                    codebook: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32 or bf16 @ codebook[idx (K, N) int8] -> (M, N) f32, with
    a per-tensor codebook (L,) f32, L <= 16."""
    if x.dim() != 2 or idx.dim() != 2 or x.shape[1] != idx.shape[0] \
            or codebook.dim() != 1:
        raise ValueError(f"codebook_matmul: x (M, K), idx (K, N) and "
                         f"codebook (L,) expected; got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(codebook.shape)}")
    if not 1 <= codebook.shape[0] <= MAX_LEVELS:
        raise ValueError(f"codebook_matmul: 1 to {MAX_LEVELS} levels, got "
                         f"{codebook.shape[0]}")
    dev = check_operands("codebook_matmul",
                         (x, (torch.float32, torch.bfloat16), "x"),
                         (idx, torch.int8, "idx"),
                         (codebook, torch.float32, "codebook"))
    if dev.type == "cpu":
        return codebook_matmul_plain(x, idx, codebook)
    m, k = x.shape
    n = idx.shape[1]
    plan = _plan(m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    launch("codebook_matmul", "codebook_matmul_launch", _ARGTYPES,
           x.data_ptr(), int(x.dtype == torch.bfloat16), idx.data_ptr(),
           codebook.data_ptr(), out.data_ptr(), m, k, n, codebook.shape[0],
           plan.bm, plan.split, plan.k_chunk,
           torch.cuda.current_stream(dev).cuda_stream)
    launches["codebook_matmul"] += 1
    return out
