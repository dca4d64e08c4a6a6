"""Per-core post-training quantization — fit one codebook per *physical
core*, not per layer.  Port of `repro.deploy.quantize`.

The chip constraint (C3) is that all synapses in a core share one N×W-bit
table.  After the compiler has placed a network, a layer may span several
cores (partition work-spreading), and each core then deserves its own
codebook fitted to just the weight columns it holds — strictly better
than reusing the whole-layer table.  This module slices the trained
weight matrices along the placed neuron ranges, runs `quant.quantize` per
slice, lowers every fitted table to W-bit register words, and reassembles
the dequantized matrices the simulator/engine executes — so the deployed
network is *defined* by the RegisterTables, with nothing else in the
loop.

The fits run where the weights lie: on their device when they are
tensors, else on `device` (default: the card).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import quant as Q
from repro_torch.core.neuron import LIFParams
from repro_torch.core.soc import Mapping, RegisterTable
from repro_torch.device import resolve_device


@dataclasses.dataclass
class PerCoreQuant:
    """The PTQ stage's output: everything the chip needs, plus telemetry."""

    weights: list                 # dequantized f32 matrices (engine input)
    tables: list[RegisterTable]   # one programmed table per core assignment
    slices: dict                  # (layer, core_id) -> QuantizedTensor
    rms_error: list[float]        # per-layer relative RMS quantization error

    @property
    def n_tables(self) -> int:
        return len(self.tables)

    def table_bits(self) -> int:
        """Register bits spent on codebooks across the chip."""
        return sum(len(t.codebook_words) * t.weight_bits for t in self.tables)


def fit_per_core_codebooks(params, mapping: Mapping, cfg: Q.CodebookConfig,
                           lif: LIFParams | None = None,
                           device=None) -> PerCoreQuant:
    """Fit one codebook per core assignment of `mapping` and lower to
    register tables.

    `params` are the trained per-layer float matrices; each assignment's
    codebook is fitted on w[:, lo:hi] only.  Dequantization goes through
    the W-bit register-word round trip (`quant.dequantize_via_registers`)
    so the returned weights are bit-exactly what the programmed chip
    computes.  Tensors are fitted where they lie unless `device` is
    given; anything else goes to `device` (default: the card).
    """
    lif = lif or LIFParams()
    # per-core PTQ is by definition ONE shared table per core: a grouped
    # CodebookConfig would both fight the slice widths (arbitrary column
    # counts from the placer) and leave the RegisterTable holding only one
    # of several groups — so the slice fit always uses a whole-slice
    # codebook, keeping "the RegisterTables define the deployed network"
    cfg = dataclasses.replace(cfg, group_size=0)
    weights_out = []
    tables: list[RegisterTable] = []
    slices: dict = {}
    rms: list[float] = []
    for li, w in enumerate(params, start=1):
        if isinstance(w, torch.Tensor) and device is None:
            w = w.detach().to(torch.float32)
        else:
            w = torch.as_tensor(
                w.detach() if isinstance(w, torch.Tensor)
                else np.asarray(w, np.float32),
                dtype=torch.float32, device=resolve_device(device))
        asn = sorted(mapping.cores_of_layer(li), key=lambda a: a.neuron_lo)
        if not asn:
            raise ValueError(f"mapping holds no cores for layer {li}")
        covered = [(a.neuron_lo, a.neuron_hi) for a in asn]
        if covered[0][0] != 0 or covered[-1][1] != int(w.shape[1]) or any(
                a_hi != b_lo for (_, a_hi), (b_lo, _) in zip(covered, covered[1:])):
            raise ValueError(
                f"layer {li}: core slices {covered} do not tile "
                f"0..{int(w.shape[1])}")
        deq_parts = []
        for a in asn:
            q = Q.quantize(w[:, a.neuron_lo:a.neuron_hi], cfg)
            slices[(li, a.core_id)] = q
            words, scale = Q.register_entry_for_slice(q, cfg, 0)
            tables.append(RegisterTable(
                core_id=a.core_id, threshold=lif.threshold, leak=lif.leak,
                reset=lif.reset, weight_levels=cfg.n_levels,
                weight_bits=cfg.bit_width, codebook_words=words,
                codebook_scale=scale))
            deq_parts.append(Q.dequantize_via_registers(q, cfg.bit_width))
        wq = torch.cat(deq_parts, dim=1)
        weights_out.append(wq)
        # f32 means and an f32 quotient, as the reference computes them
        denom = float(torch.sqrt(torch.mean(w ** 2)))
        rms.append(float(torch.sqrt(torch.mean((w - wq) ** 2))
                         / max(denom, 1e-12)))
    return PerCoreQuant(weights=weights_out, tables=tables, slices=slices,
                        rms_error=rms)
