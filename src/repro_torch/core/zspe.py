"""ZSPE + SPE — zero-skip sparse spike processing (paper C1) and its cycle
model, in torch.  Port of `repro.core.zspe`: the scalar cycle model serves
the interpretive reference engine, the array form the array engines.

Spike words are the chip's on-wire spike format: 16 spikes per uint16
word, LSB first, the last word zero-padded.  torch has no shifts for
`torch.uint16`, so the bit arithmetic runs in int32 and the words are
stored as uint16 by reinterpreting the low half (`int16` then `.view`),
which keeps the packed layout bit-for-bit that of the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def zspe_matmul(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Spike-driven synaptic integration: (B, n_pre) {0,1} x (n_pre, n_post).

    Zero-skip is a *performance* feature; semantics are the plain product
    (the zspe kernel, kernels/zspe_spmm.py, must match it).
    """
    return spikes.to(weights.dtype) @ weights


def zspe_matmul_q(spikes: torch.Tensor, q) -> torch.Tensor:
    """`zspe_matmul` against a `QuantizedTensor`'s dequantized weights."""
    from repro_torch.core.quant import dequantize

    return zspe_matmul(spikes, dequantize(q))


SPIKE_WORD_BITS = 16


def spike_word_count(n: int) -> int:
    """Words needed for `n` spikes (the last word zero-padded)."""
    return -(-int(n) // SPIKE_WORD_BITS)


def _bit_weights(device) -> torch.Tensor:
    return torch.arange(SPIKE_WORD_BITS, dtype=torch.int32, device=device)


def pack_spike_words(spikes: torch.Tensor) -> torch.Tensor:
    """(..., K) {0,1} -> (..., ceil(K/16)) uint16, LSB-first per word."""
    k = spikes.shape[-1]
    kw = spike_word_count(k)
    bits = (spikes != 0).to(torch.int32)
    pad = kw * SPIKE_WORD_BITS - k
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*bits.shape[:-1], kw, SPIKE_WORD_BITS)
    words = (bits << _bit_weights(spikes.device)).sum(-1, dtype=torch.int32)
    return words.to(torch.int16).contiguous().view(torch.uint16)


def words_as_int32(packed: torch.Tensor) -> torch.Tensor:
    """uint16 spike words -> the same values as int32 (0..65535)."""
    return packed.view(torch.int16).to(torch.int32) & 0xFFFF


def unpack_spike_words(packed: torch.Tensor, n: int | None = None
                       ) -> torch.Tensor:
    """Inverse of `pack_spike_words` -> (..., n) f32 {0,1}.

    `n` crops the trailing word's zero padding (defaults to all 16*Kw
    lanes, which is the padded width the fused kernel consumes).
    """
    words = words_as_int32(packed)
    bits = (words[..., None] >> _bit_weights(packed.device)) & 1
    flat = bits.reshape(*packed.shape[:-1], packed.shape[-1] * SPIKE_WORD_BITS)
    if n is not None:
        flat = flat[..., :n]
    return flat.to(torch.float32)


def empty_spike_words(packed: torch.Tensor) -> torch.Tensor:
    """Per-row count of all-zero 16-spike words (the ZSPE word-scan skip)."""
    return (words_as_int32(packed) == 0).sum(-1, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class CoreGeometry:
    """Per-core resources (register-table configurables + fixed datapath)."""

    spike_lanes: int = 16        # ZSPE parallel spike window
    spe_lanes: int = 4           # synapses processed per cycle (2 SPEs x 2)
    freq_hz: float = 200e6       # nominal core clock
    max_neurons: int = 8192      # 160K neurons / 20 cores
    pipeline_depth: int = 4      # caches -> ZSPE -> SPE -> updater
    write_lanes: int = 4         # register-table index writes per cycle
                                 # (plasticity stage; shares the SPE port
                                 # width into the weight-index SRAM)


@dataclasses.dataclass(frozen=True)
class CycleModel:
    """Cycle/throughput model of one neuromorphic core.

    Per core-timestep: spike-load cycles ceil(n_pre / 16) (ZSPE scan),
    synapse cycles ceil(nnz * n_post / 4) (SPE, zero-skip), update cycles
    ceil(n_touched) (neuron updater), and with plasticity the index writes
    through `write_lanes` ports; the pipeline overlaps them, so a step
    costs the slowest stage plus the pipeline depth.
    """

    geom: CoreGeometry = CoreGeometry()

    def stage_cycles(self, n_pre: int, n_post: int, nnz: float,
                     touched: float, zero_skip: bool = True,
                     partial_update: bool = True):
        """(load, synapse, update) cycles of one core-timestep, as ints:
        the SPEs cannot issue a fractional cycle."""
        g = self.geom
        load = -(-n_pre // g.spike_lanes)
        syn = math.ceil((nnz if zero_skip else n_pre) * n_post
                        / g.spe_lanes)
        upd = math.ceil(touched) if partial_update else n_post
        return load, syn, upd

    def timestep_cycles(self, n_pre: int, n_post: int, nnz: float,
                        touched: float, zero_skip: bool = True,
                        partial_update: bool = True,
                        writes: float | None = None) -> float:
        """Cycles of one core-timestep: the slowest stage (the plasticity
        stage's index writes among them, when `writes` is given) plus the
        pipeline depth."""
        crit = max(self.stage_cycles(n_pre, n_post, nnz, touched,
                                     zero_skip, partial_update))
        if writes is not None:
            crit = max(crit, math.ceil(writes / self.geom.write_lanes))
        return crit + self.geom.pipeline_depth

    def stage_cycles_array(self, n_pre: int, n_post, nnz, touched,
                           zero_skip: bool = True,
                           partial_update: bool = True):
        """(load, synapse, update) cycles of each core slice of a layer:
        `n_post`/`touched` hold one entry per slice, `nnz` one per sample
        (broadcast).  Integer-exact inputs make the ceils exact."""
        g = self.geom
        load = -(-n_pre // g.spike_lanes)
        syn = torch.ceil((nnz if zero_skip else float(n_pre)) * n_post
                         / g.spe_lanes)
        upd = torch.ceil(touched) if partial_update else n_post
        return load, syn, upd

    def timestep_cycles_array(self, n_pre: int, n_post, nnz, touched,
                              zero_skip: bool = True,
                              partial_update: bool = True, writes=None):
        """Cycles of one core-timestep per slice: the slowest stage plus
        the pipeline depth, in f32 like the reference.  `writes` (per
        slice, integer-exact) adds the plasticity stage; None issues the
        inference ops alone."""
        load, syn, upd = self.stage_cycles_array(
            n_pre, n_post, nnz, touched, zero_skip, partial_update)
        crit = torch.maximum(torch.clamp(syn, min=float(load)),
                             torch.as_tensor(upd, dtype=torch.float32,
                                             device=syn.device))
        if writes is not None:
            crit = torch.maximum(crit,
                                 torch.ceil(writes / self.geom.write_lanes))
        return crit + self.geom.pipeline_depth

    def sop_count(self, n_pre: int, n_post: int, nnz: float,
                  zero_skip: bool = True) -> float:
        """SOPs actually *performed*.  With zero-skip only valid-spike
        synapses are ops; the baseline performs them all (zeros included)."""
        return (nnz if zero_skip else n_pre) * n_post

    def gsops(self, n_pre: int, n_post: int, sparsity: float,
              zero_skip: bool = True, partial_update: bool = True) -> float:
        """Computing efficiency (GSOP/s) at a given spike sparsity: SOPs
        delivered per second, a delivered SOP being a valid-spike synaptic
        update (the paper's Fig. 3 convention, so at sparsity 1.0 the
        throughput is 0).  The touched neurons are the reference's rough
        estimate, n_post * min(1, 4 nnz / n_post)."""
        nnz = n_pre * (1.0 - sparsity)
        touched = n_post * min(1.0, nnz / max(n_post, 1) * 4)
        cyc = self.timestep_cycles(n_pre, n_post, nnz, touched,
                                   zero_skip, partial_update)
        sops = n_pre * (1.0 - sparsity) * n_post
        return sops / cyc * self.geom.freq_hz / 1e9
