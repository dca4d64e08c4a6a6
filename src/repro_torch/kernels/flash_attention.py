"""Flash attention (tiled online-softmax SDPA) on Hopper.

Port of `repro.kernels.flash_attention` (the Pallas TPU kernel on the LM
train / prefill self-attention path).  Three parts, as in the other
kernel modules:

* the CUDA kernel in `csrc/flash_attention.cu`, launched on the current
  stream for CUDA tensors;
* its plain version, `flash_attention_plain`: the kv heads repeated to H,
  then the oracle `ref.flash_attention_ref`; the wrapper uses it for CPU
  tensors;
* a launch count (`launches`), raised by one exactly where the kernel is
  launched.

The shape contract is the reference's (S and T multiples of its 128-row
blocks, H a multiple of KV), raised as `ValueError` where the reference
asserts.  Two kernels, chosen by `_route` from the type and head dim:
bf16 at head dims 64, 96 (phi-3-vision, in three 32-column panels) and
128 runs the tensor-core kernel (`wgmma` fed by TMA); f32 at head dims
16, 32, 64, 80, 96 and 128, and bf16 at 16, 32 and 80 (zamba2, whose
4096-token window keeps it off every driven flash route), run the SIMT
kernel.  `supports` states the shapes the kernel launches for; on a
CUDA tensor of any other shape the wrapper raises, so a caller that may
meet one (`models.attention`) asks first.
`launches["flash_attention"]` counts every launch,
`launches["flash_attention_wgmma"]` those of the tensor-core kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_operands, launch

launches = {"flash_attention": 0, "flash_attention_wgmma": 0}

BLOCK = 128                   # the reference's bq = bk: S, T multiples of it
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
WGMMA_HEAD_DIMS = (64, 96, 128)   # swizzled panels of 64 or 32 bf16
MAX_GRID_Y = 65535            # B * H rides in the SIMT grid's y dimension
TMA_ALIGN = 16                # bytes: a tensor map's base address

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 8 + [ctypes.c_float, _P]
_WGMMA_ARGTYPES = [_P] * 4 + [_I] * 7 + [ctypes.c_float, _P]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _route(dtype: torch.dtype, hd: int) -> str:
    """Which instantiation a launch takes: "wgmma" (bf16 tensor cores) or
    "simt" (f32 FMAs; the reference's f32 dots rule out TF32)."""
    return ("wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
            else "simt")


def supports(dtype: torch.dtype, hd: int, b: int, h: int) -> bool:
    """Whether the kernel launches for q of this type, head dim, batch
    and head count (the sequence conditions are the caller's to meet:
    multiples of 128)."""
    return (dtype in (torch.float32, torch.bfloat16) and hd in HEAD_DIMS
            and b * h <= MAX_GRID_Y)


def flash_attention_plain(q, k, v, causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain torch: GQA by repeating each kv head
    over its group of query heads, then one-pass f32 SDPA."""
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    return ref.flash_attention_ref(q, k, v, causal=causal)


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B, H, S, hd) and k, v (B, KV, "
                         f"T, hd) expected; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, hd = q.shape
    kvh, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} in batch or head dim")
    if s % BLOCK or t % BLOCK:
        raise ValueError(f"flash_attention: S = {s} and T = {t} must be "
                         f"multiples of {BLOCK}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {kvh} kv heads")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, H, S, hd), k / v (B, KV, T, hd) -> (B, H, S, hd) in q's type.

    GQA: query head h reads kv head h // (H / KV), with no copy of K/V.
    """
    _check_shapes(q, k, v)
    dev = check_operands("flash_attention",
                         (q, (torch.float32, torch.bfloat16), "q"),
                         (k, q.dtype, "k"), (v, q.dtype, "v"))
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    b, h, s, hd = q.shape
    kvh, t = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"flash_attention: B * H = {b * h} above "
                         f"{MAX_GRID_Y}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if _route(q.dtype, hd) == "wgmma":
        for what, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % TMA_ALIGN:
                raise ValueError(f"flash_attention: {what} must be "
                                 f"{TMA_ALIGN}-byte aligned for TMA")
        launch("flash_attention", "flash_attention_wgmma_launch",
               _WGMMA_ARGTYPES, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), b, h, kvh, s, t, hd, int(causal), hd ** -0.5,
               stream)
        launches["flash_attention_wgmma"] += 1
    else:
        launch("flash_attention", "flash_attention_launch", _ARGTYPES,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
               h, kvh, s, t, hd, int(causal), int(q.dtype == torch.bfloat16),
               hd ** -0.5, stream)
    launches["flash_attention"] += 1
    return out


def hbm_io_bytes(b: int, h: int, s: int, t: int, hd: int,
                 dtype_bytes: int = 2, with_backward: bool = True) -> int:
    """Analytic HBM traffic of the kernel (the roofline-adjustment term):
    fwd reads q,k,v + writes o; bwd reads q,k,v,o,do + writes dq,dk,dv
    (scores recomputed in VMEM).  Used by §Perf H2."""
    q = b * h * s * hd * dtype_bytes
    kv = 2 * b * h * t * hd * dtype_bytes
    fwd = (q + kv) + q                    # read q,k,v ; write o
    if not with_backward:
        return fwd
    bwd = (2 * q + kv) + q + (q + kv)     # read q,o,do,k,v ; write dq,dk,dv
    return fwd + bwd
