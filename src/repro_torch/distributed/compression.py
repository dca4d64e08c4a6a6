"""Gradient compression for the DP axis: int8 quantization with error
feedback (residual accumulation), applied before the data-parallel
all-reduce.  At 1000+ nodes the DP all-reduce is bandwidth-bound; 4x
fewer bytes on the wire is a direct multiplier on the collective roofline
term.

Port of `repro.distributed.compression`, on dicts (or any list / tuple /
dict tree, `optim.adamw.tree_map`) of tensors.  Error feedback keeps the
scheme unbiased over time: the quantization residual of step t is added
back into the gradient at t+1 (Seide et al., Karimireddy et al.).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import tree_map


class CompressionState(NamedTuple):
    residual: Any          # same structure as grads, f32


def init(grads_shape: Any) -> CompressionState:
    """Zero residuals shaped like `grads_shape` (tensors or shapes)."""
    def zeros(s):
        shape = s.shape if hasattr(s, "shape") else s
        device = s.device if isinstance(s, torch.Tensor) else None
        return torch.zeros(tuple(shape), dtype=torch.float32, device=device)

    return CompressionState(residual=tree_map(zeros, grads_shape))


def compress(g: torch.Tensor, res: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g (+ carried residual) -> (int8 payload, scale, new residual)."""
    corrected = g.to(torch.float32) + res
    scale = torch.clamp(torch.max(torch.abs(corrected)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, corrected - deq


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_grads(grads: Any, state: CompressionState
                     ) -> tuple[Any, CompressionState]:
    """Round-trip every leaf through int8 + error feedback: the int8
    payload is what would cross the DP axis; this gives the numerics and
    the state plumbing."""
    pairs = tree_map(lambda g, r: _round_trip(g, r), grads, state.residual)
    return (_pick(grads, pairs, 0),
            CompressionState(residual=_pick(grads, pairs, 1)))


def _round_trip(g, r):
    q, s, nr = compress(g, r)
    return decompress(q, s).to(g.dtype), nr


def _pick(like, tree, i):
    if isinstance(like, dict):
        return {k: _pick(like[k], tree[k], i) for k in like}
    if isinstance(like, (list, tuple)):
        out = [_pick(x, tree[j], i) for j, x in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    return tree[i]
