"""Diagnostic probe networks for the NoC accounting model.

Port of `repro.core.probes`, on torch.  `source_exact_probe` builds the
canonical source-exactness witness: an identity first layer split over
several physical cores so the hidden firing pattern — and therefore the
NoC *source cores* — mirror the input spikes exactly.  Firing the slice
on the core nearest the output core vs the slice on the farthest one
moves the same spike count to a different source, which must change
`noc_energy_pj`/`noc_hops` under per-flow accounting (and could not under
a uniform-split heuristic).  The telemetry tests run their traces on it.
"""
from __future__ import annotations

import numpy as np
import torch


def source_exact_probe(engine: str = "compiled", n: int = 64,
                       slice_n: int = 8, seed: int = 13, **kw):
    """Returns (sim, srcs, dst): a ChipSimulator whose first (identity)
    layer is split into `n // slice_n` slices on cores `srcs`, feeding a
    10-neuron output layer on core `dst`.  `kw` goes to the simulator
    (`device=`, `trace=`, `faults=`, ...)."""
    from repro_torch.core import noc as NOC
    from repro_torch.core.soc import ChipSimulator, CoreAssignment, Mapping

    rng = np.random.default_rng(seed)
    eye = 2.0 * np.eye(n, dtype=np.float32)
    w2 = rng.normal(0, 0.2, (n, 10)).astype(np.float32)
    srcs = [int(c) for c in NOC.core_ids()[:n // slice_n]]
    dst = int(NOC.core_ids()[n // slice_n])
    mapping = Mapping(
        assignments=[CoreAssignment(core_id=c, layer=1,
                                    neuron_lo=i * slice_n,
                                    neuron_hi=(i + 1) * slice_n)
                     for i, c in enumerate(srcs)]
        + [CoreAssignment(core_id=dst, layer=2, neuron_lo=0, neuron_hi=10)],
        layer_sizes=[n, n, 10])
    return ChipSimulator([eye, w2], engine=engine, mapping=mapping, **kw), \
        srcs, dst


def source_exact_patterns(sim, srcs, dst, slice_n: int = 8, steps: int = 6):
    """(near, far, (near_hops, far_hops)): two (1, steps, n) spike trains
    on the simulator's device with EQUAL total spikes — one fires only
    the slice whose core sits nearest `dst`, the other only the farthest
    slice."""
    n = int(sim.weights[0].shape[0])
    dist = sim.routing.dist
    near = int(np.argmin([dist[c, dst] for c in srcs]))
    far = int(np.argmax([dist[c, dst] for c in srcs]))
    lo = torch.zeros((1, steps, n), device=sim.device)
    hi = torch.zeros((1, steps, n), device=sim.device)
    lo[:, :, near * slice_n:(near + 1) * slice_n] = 1.0
    hi[:, :, far * slice_n:(far + 1) * slice_n] = 1.0
    return lo, hi, (int(dist[srcs[near], dst]), int(dist[srcs[far], dst]))
