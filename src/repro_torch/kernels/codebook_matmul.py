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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_operands, launch

launches = {"codebook_matmul": 0}

MAX_LEVELS = 16      # the kernel's compare-and-select table

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _P] + [_I] * 4 + [_P]


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
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    launch("codebook_matmul", "codebook_matmul_launch", _ARGTYPES,
           x.data_ptr(), int(x.dtype == torch.bfloat16), idx.data_ptr(),
           codebook.data_ptr(), out.data_ptr(), m, k, n, codebook.shape[0],
           torch.cuda.current_stream(dev).cuda_stream)
    launches["codebook_matmul"] += 1
    return out
