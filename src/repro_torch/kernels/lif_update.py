"""Fused partial-update LIF neuron step (paper C2) on Hopper.

Port of `repro.kernels.lif_update` (the Pallas TPU kernel behind
`ops.lif_update`).  Three parts, as in `fused_timestep.py`:

* the CUDA kernel in `csrc/lif_update.cu`, launched on the current stream
  for CUDA tensors;
* its plain version, `lif_update_plain`: the oracle `ref.lif_update_ref`
  with the kernel's int8 `updated`; the wrapper uses it for CPU tensors;
* a launch count (`launches`), raised by one exactly where the kernel is
  launched.

`has_input` is `current != 0`, not the connectivity touch mask of the
fused kernel.  The outputs are new tensors; the inputs are not written.
The kernel is launched as a programmatic dependent of the previous kernel
on the stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_operands, launch

launches = {"lif_update": 0}

_P = ctypes.c_void_p
_F = ctypes.c_float
_ARGTYPES = [_P] * 7 + [ctypes.c_longlong] + [_F] * 3 + [_P]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def lif_update_plain(v, elapsed, current, *, threshold, leak, reset):
    """The kernel's function in plain torch: (v', elapsed', spikes, updated
    int8)."""
    vo, eo, sp, upd = ref.lif_update_ref(v, elapsed, current,
                                         threshold=threshold, leak=leak,
                                         reset=reset)
    return vo, eo, sp, upd.to(torch.int8)


def lif_update(v: torch.Tensor, elapsed: torch.Tensor, current: torch.Tensor,
               *, threshold: float = 1.0, leak: float = 0.9,
               reset: float = 0.0):
    """(B, N) fused LIF step.  v and current f32, elapsed int32.

    Returns (v', elapsed', spikes f32, updated int8).
    """
    if v.dim() != 2 or elapsed.shape != v.shape or current.shape != v.shape:
        raise ValueError(f"lif_update: v, elapsed and current must be one "
                         f"(B, N) shape; got {tuple(v.shape)}, "
                         f"{tuple(elapsed.shape)}, {tuple(current.shape)}")
    dev = check_operands("lif_update", (v, torch.float32, "v"),
                         (elapsed, torch.int32, "elapsed"),
                         (current, torch.float32, "current"))
    lif = dict(threshold=threshold, leak=leak, reset=reset)
    if dev.type == "cpu":
        return lif_update_plain(v, elapsed, current, **lif)
    v_out = torch.empty_like(v)
    el_out = torch.empty_like(elapsed)
    spikes = torch.empty_like(v)
    updated = torch.empty(v.shape, dtype=torch.int8, device=v.device)
    launch("lif_update", "lif_update_launch", _ARGTYPES, v.data_ptr(),
           elapsed.data_ptr(), current.data_ptr(), v_out.data_ptr(),
           el_out.data_ptr(), spikes.data_ptr(), updated.data_ptr(),
           v.numel(), float(threshold), float(leak), float(reset),
           torch.cuda.current_stream(dev).cuda_stream)
    launches["lif_update"] += 1
    return v_out, el_out, spikes, updated
