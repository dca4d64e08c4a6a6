"""Carry a network's parameters into the port from plain arrays.

`convert` takes numpy arrays and Python tuples only — never objects of
another package — so anything that can export its quantized tensors,
mapping and register tables as arrays (the JAX reference, a checkpoint)
hands the port the very same network, and both compute the same thing.
`convert_lm` does the same for the LM's nested parameter dict, and
`convert_params` / `convert_adamw` for an SNN's training state (the
parameter tree and the AdamW step and moments).  `lm_tree` /
`load_lm_tree` map between the port's per-layer `Transformer` parameter
names and the reference's nested dict with stacked (L, ...) blocks, the
layout of an LM training checkpoint in either package.
"""
from __future__ import annotations

from typing import Mapping as _Map, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.core.soc import CoreAssignment, Mapping, RegisterTable
from repro_torch.device import resolve_device

_QUANT_KEYS = ("idx", "codebook", "scale", "group_axis_size")


class Converted(NamedTuple):
    weights: list              # QuantizedTensors or f32 tensors, per layer
    mapping: Mapping | None
    register_tables: list | None


def _layer(layer, dev):
    if isinstance(layer, _Map):
        missing = [k for k in _QUANT_KEYS if k not in layer]
        if missing:
            raise ValueError(f"quantized layer lacks {missing}")
        idx = np.asarray(layer["idx"])
        if idx.dtype != np.int8:
            raise TypeError(f"idx must be int8, got {idx.dtype}")
        return QuantizedTensor(
            idx=torch.tensor(idx, device=dev),
            codebook=torch.tensor(np.asarray(layer["codebook"], np.float32),
                                  device=dev),
            scale=torch.tensor(np.asarray(layer["scale"], np.float32),
                               device=dev),
            group_axis_size=int(layer["group_axis_size"]))
    return torch.tensor(np.asarray(layer, np.float32), device=dev)


def convert(layers: Sequence, mapping: Sequence[tuple] | None = None,
            register_tables: Sequence[_Map] | None = None,
            device=None) -> Converted:
    """Build the port's weights, Mapping and RegisterTables.

    `layers`: per layer either a float (n_pre, n_post) matrix or a dict
    with `idx` (int8), `codebook` (G, N), `scale` (G,) and
    `group_axis_size` — a quantized tensor.  `mapping`: optional rows
    `(core_id, layer, neuron_lo, neuron_hi)`.  `register_tables`: optional
    dicts of `RegisterTable` fields.  Tensors go to `device` (default: the
    card, see `repro_torch.resolve_device`).
    """
    dev = resolve_device(device)
    weights = [_layer(layer, dev) for layer in layers]
    mp = None
    if mapping is not None:
        shapes = [w.shape for w in weights]
        sizes = [int(shapes[0][0])] + [int(s[1]) for s in shapes]
        mp = Mapping(assignments=[CoreAssignment(int(c), int(l), int(lo),
                                                 int(hi))
                                  for c, l, lo, hi in mapping],
                     layer_sizes=sizes)
    tables = None
    if register_tables is not None:
        tables = [RegisterTable(**{
            k: (tuple(int(x) for x in v) if k == "codebook_words" else v)
            for k, v in fields.items()}) for fields in register_tables]
    return Converted(weights, mp, tables)


def _lm_tensor(a, dev) -> torch.Tensor:
    """One array as a tensor of the same type, bit for bit: a bf16 array
    (`ml_dtypes.bfloat16`, which `torch.tensor` does not take) travels as
    its 16-bit patterns through an int16 view."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(dev)
    return torch.tensor(a, device=dev)


def convert_lm(params: _Map, cfg, device=None):
    """The port's `Transformer` from the reference's nested parameter dict
    as numpy arrays: `embed`, `unembed`, `final_norm` and `blocks` of
    stacked (L, ...) per-layer arrays, plus the family extras: the
    hybrid's `shared_attn` (one unstacked block) and the audio family's
    `encoder` (stacked (enc_layers, ...)) and `enc_final_norm`.  A block
    leaf may be the reference's C3-quantized leaf
    (`repro.quant.lm_quant.quantize_blocks`), a dict of stacked `idx`
    (int8) or `idx4` (packed uint8) and `cb` (L, N); each layer gets its
    slice.  Types are kept, bf16 included; tensors go to `device`
    (default: the card)."""
    from repro_torch.models.transformer import Transformer

    dev = resolve_device(device)

    def layers_of(leaf) -> int:
        return len(leaf["cb"]) if isinstance(leaf, _Map) else len(leaf)

    def layer(leaf, i):
        if isinstance(leaf, _Map):
            return {k: _lm_tensor(a[i], dev) for k, a in leaf.items()}
        return _lm_tensor(leaf[i], dev)

    def unstack(stacked: _Map, n: int, what: str) -> list:
        counts = {name: layers_of(leaf) for name, leaf in stacked.items()}
        if set(counts.values()) != {n}:
            raise ValueError(f"stacked {what} {counts} do not hold {n} "
                             f"layers")
        return [{name: layer(leaf, i) for name, leaf in stacked.items()}
                for i in range(n)]

    extras = {}
    if "shared_attn" in params:
        extras["shared_attn"] = {k: _lm_tensor(a, dev)
                                 for k, a in params["shared_attn"].items()}
    if "encoder" in params:
        extras["encoder"] = unstack(params["encoder"], cfg.enc_layers,
                                    "encoder")
        extras["enc_final_norm"] = _lm_tensor(params["enc_final_norm"], dev)
    return Transformer(cfg, _lm_tensor(params["embed"], dev),
                       _lm_tensor(params["unembed"], dev),
                       _lm_tensor(params["final_norm"], dev),
                       unstack(params["blocks"], cfg.n_layers, "blocks"),
                       **extras)


def _lm_slot(name: str) -> tuple[tuple, int | None]:
    """A `Transformer` parameter name's place in the reference's tree:
    (path, layer) for a stacked block leaf (`blocks.3.wq` ->
    (("blocks", "wq"), 3); `encoder.1.ln1` likewise), (path, None)
    otherwise (`embed`, `shared_attn.wq`)."""
    parts = name.split(".")
    if parts[0] in ("blocks", "encoder"):
        return (parts[0], parts[2]), int(parts[1])
    return tuple(parts), None


def lm_tree(named: _Map) -> dict:
    """The reference's nested LM parameter dict from tensors keyed by the
    port's `Transformer` parameter names (its `named_parameters()`, or
    AdamW moments kept under the same keys): `blocks` and `encoder`
    leaves stacked along a new layer axis, the others as they are.
    Tensors are detached; stacked leaves are new tensors."""
    slots: dict = {}
    for name, t in named.items():
        path, layer = _lm_slot(name)
        slots.setdefault(path, {})[layer] = t.detach()
    tree: dict = {}
    for path, layers in slots.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (layers[None] if None in layers else torch.stack(
            [layers[i] for i in range(len(layers))]))
    return tree


def load_lm_tree(named: _Map, tree: _Map) -> None:
    """Copy the reference-layout `tree` (as `lm_tree` gives it; tensors
    or numpy arrays) into the tensors of `named` in place, each layer its
    slice of the stacked leaves.  A DTensor takes its own shard of the
    full leaf."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        for name, t in named.items():
            path, layer = _lm_slot(name)
            leaf = tree
            for key in path:
                leaf = leaf[key]
            if layer is not None:
                leaf = leaf[layer]
            if not isinstance(leaf, torch.Tensor):
                leaf = _lm_tensor(np.asarray(leaf), t.device)
            if isinstance(t, DTensor):
                from repro_torch.distributed import sharding as SH

                mesh = t.device_mesh
                part = SH.shard(leaf.to(t.device, t.dtype),
                                SH.spec_of(t.placements, t.ndim, mesh), mesh)
                t.to_local().copy_(part.to_local())
            else:
                t.copy_(leaf)


def convert_params(tree, device=None):
    """A tree (lists, tuples, dicts) of arrays as the same tree of
    tensors, types kept bit for bit (bf16 too); tensors go to `device`
    (default: the card).  For the SNN models' parameter lists and the
    conv model's dict."""
    from repro_torch.optim.adamw import tree_map

    dev = resolve_device(device)
    return tree_map(lambda a: _lm_tensor(np.asarray(a), dev), tree)


def convert_adamw(step, m, v, device=None):
    """The port's `AdamWState` from a step count and moment trees of
    arrays (the reference's `AdamWState` fields as numpy); the step
    becomes a () int32 tensor."""
    from repro_torch.optim.adamw import AdamWState

    dev = resolve_device(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        m=convert_params(m, dev), v=convert_params(v, dev))
