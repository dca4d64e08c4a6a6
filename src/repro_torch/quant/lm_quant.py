"""Codebook (C3) quantization applied to LM weights for serving.

Port of `repro.quant.lm_quant`.  The chip stores synapse weights as
log2(N)-bit indexes into a per-core N x W-bit table; the LM analogue
quantizes every large matmul weight to int8 indexes (or two 4-bit
indexes a byte) and a per-layer codebook, so serving reads about 2x (4x)
fewer device-memory bytes per weight than bf16.

`quantize_blocks` fits each layer's leaf alone and returns a model whose
blocks hold the reference's `{"idx" | "idx4", "cb"}` as buffers;
`make_param_transform` is the hook prefill and decode apply to each
layer's leaves.  A 2-D leaf becomes a `models.common.CodebookWeight`,
which `linear` multiplies on the `codebook_matmul` kernel: the dequant
happens inside the kernel and the weight traffic is the int8 indexes.
The expert stacks (E, in, out) of the moe family are gathered into dense
weights, as the reference does.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch

from repro_torch.core.quant import (CodebookConfig, pack_indexes_4bit,
                                    quantize, unpack_indexes_4bit)
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.common import CodebookWeight, gather_codebook

# weights worth quantizing: stacked (L, in, out) projection matrices
_QUANT_MIN_SIZE = 1 << 16


def _quantizable(name: str, w: torch.Tensor, n_layers: int) -> bool:
    """The reference's rule on its stacked (L, ...) leaf: ndim >= 3, size
    >= 2^16, bf16 or f32, not a norm.  The port holds one layer at a time,
    so the stacked leaf has one more dim and n_layers times the size."""
    return (w.dim() + 1 >= 3 and n_layers * w.numel() >= _QUANT_MIN_SIZE
            and w.dtype in (torch.bfloat16, torch.float32)
            and not name.startswith("ln"))


def _is_quantized(leaf) -> bool:
    return isinstance(leaf, Mapping) and ("idx" in leaf or "idx4" in leaf)


def _indexes(leaf: Mapping) -> torch.Tensor:
    """A quantized leaf's int8 indexes, unpacked from `idx4` if packed."""
    if "idx4" in leaf:
        return unpack_indexes_4bit(leaf["idx4"], leaf["idx4"].shape[-1] * 2)
    return leaf["idx"]


def _dense(leaf: Mapping, dtype) -> torch.Tensor:
    """cb[idx] as a dense tensor of `dtype` (the reference's transform)."""
    return leaf["cb"].to(dtype)[_indexes(leaf).long()]


def quantize_blocks(model, cfg: CodebookConfig | None = None,
                    pack_4bit: bool = False):
    """A `Transformer` whose quantizable block leaves are
    `{"idx": int8 | "idx4": packed uint8, "cb": (N,) f32}`, the others
    passed through (embeddings and norms are the same tensors).  The
    family extras (the hybrid's `shared_attn`, the audio encoder) are
    carried over unquantized: the reference's launcher quantizes
    `params["blocks"]` only.

    Each layer's leaf is fitted alone as one flat row (the reference's
    `jax.vmap(q_one)` over the stacked leaf), where the weights lie.
    pack_4bit (N <= 16 only) stores two indexes per byte, the chip's real
    synapse-SRAM format.
    """
    from repro_torch.models.transformer import Transformer

    cfg = cfg or CodebookConfig(n_levels=16, bit_width=8)
    n_layers = len(model.blocks)
    blocks = []
    for block in model.blocks:
        out = {}
        for name, w in block.leaves().items():
            if _is_quantized(w) or not _quantizable(name, w, n_layers):
                out[name] = w
                continue
            qt = quantize(w.detach().reshape(1, -1), cfg)
            idx = qt.idx.reshape(w.shape).to(torch.int8)
            entry = {"cb": qt.codebook[0].to(torch.float32)}
            if pack_4bit:             # CodebookConfig holds N <= 16
                if w.shape[-1] % 2:
                    raise ValueError("4-bit packing needs an even last dim")
                entry["idx4"] = pack_indexes_4bit(idx)
            else:
                entry["idx"] = idx
            out[name] = entry
        blocks.append(out)
    return Transformer(model.cfg, model.embed, model.unembed,
                       model.final_norm, blocks, **model.extras())


def _on_shards(leaf: Mapping, dtype):
    """A quantized leaf of DTensors (a model laid out on a mesh) as its
    operand: the indexes stay packed, each device unpacking its own
    shard."""
    packed = "idx4" in leaf
    idx = leaf["idx4"] if packed else leaf["idx"]
    if idx.dim() == 2:
        return CodebookWeight(idx, leaf["cb"].to(dtype).to(torch.float32),
                              packed)
    return gather_codebook(CodebookWeight(idx, leaf["cb"].to(dtype), packed))


def make_param_transform(dtype=torch.bfloat16) -> Callable[[dict], dict]:
    """The hook prefill and decode apply to each layer's leaves: a
    quantized leaf becomes the operand that computes the reference's
    `cb[idx].astype(dtype)`.  A 2-D leaf is a `CodebookWeight` (int8
    indexes, the codebook rounded to `dtype` and held in f32, for the
    kernel); an expert stack (E, in, out) the dense `cb.to(dtype)[idx]`.
    On a mesh (DTensor leaves) a 4-bit leaf stays packed in its
    `CodebookWeight` and an expert stack is gathered on each device's
    own experts (`models.common.gather_codebook`).
    """

    def transform(lp: dict) -> dict:
        out = {}
        for name, v in lp.items():
            if not _is_quantized(v):
                out[name] = v
            elif any(is_dtensor(t) for t in v.values()):
                out[name] = _on_shards(v, dtype)
            elif _indexes(v).dim() == 2:
                out[name] = CodebookWeight(
                    _indexes(v).contiguous(),
                    v["cb"].to(dtype).to(torch.float32).contiguous())
            else:
                out[name] = _dense(v, dtype)
        return out

    return transform


def quantized_bytes(model) -> tuple[int, int]:
    """(bytes_bf16, bytes_quantized) of the blocks, the reference's
    weight-traffic comparison: 2 bytes a weight against its index bytes
    and 4 bytes a codebook entry."""
    before = after = 0
    for block in model.blocks:
        for v in block.leaves().values():
            if isinstance(v, Mapping) and "idx" in v:
                before += v["idx"].numel() * 2
                after += v["idx"].numel() + v["cb"].numel() * 4
            elif isinstance(v, Mapping) and "idx4" in v:
                before += v["idx4"].numel() * 2 * 2
                after += v["idx4"].numel() + v["cb"].numel() * 4
            else:
                before += v.numel() * 2
                after += v.numel() * 2
    return before, after


def quantization_report(model, qmodel) -> dict:
    """Relative RMS error per quantized leaf name over all layers (PTQ
    quality check), through a dense f32 dequantization."""
    sq_err: dict = {}
    sq: dict = {}
    count: dict = {}
    for block, qblock in zip(model.blocks, qmodel.blocks):
        qleaves = qblock.leaves()
        for name, w in block.leaves().items():
            if not _is_quantized(qleaves.get(name)):
                continue
            w = w.detach().to(torch.float32)
            deq = _dense(qleaves[name], torch.float32)
            sq_err[name] = sq_err.get(name, 0.0) + torch.sum(
                (w - deq).double() ** 2)
            sq[name] = sq.get(name, 0.0) + torch.sum(w.double() ** 2)
            count[name] = count.get(name, 0) + w.numel()
    return {name: float(torch.sqrt(sq_err[name] / count[name])
                        / max(float(torch.sqrt(sq[name] / count[name])),
                              1e-12))
            for name in sq_err}
