"""Per-timestep chip tracing: raw counters out of the engines, every
derived quantity rebuilt on the host by ONE shared implementation.

Port of `repro.telemetry.trace` (numpy, as in the reference).  The
engines emit only *integer-exact* raw counters per layer-step —
per-core-slice fired/touched counts, per-layer nnz and ZSPE skip-word
counts — and `build_trace` recomputes all derived series (stage cycles,
per-core wall, router occupancy, M/M/1 contention, per-slice NoC energy)
in float64 from those integers plus the static mapping.  Counter parity
across the compiled and fused engines (and with the reference's) is
therefore a property of four raw tensors; everything downstream
(aggregate.profile, perfetto.to_perfetto) is engine-independent by
construction.

Capture is opt-in (`TraceConfig(enabled=True)`) and zero-cost when off:
the engines add trace counters to a layer-step only when the simulator
was built with an enabled config, so a disabled run issues the same
torch ops as an untraced build (tests/test_torch_telemetry.py counts
them).  When on, the extra counters are O(S + L) values per step (S =
core slices, L = layers).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core import noc as NOC

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (soc -> telemetry)
    from repro_torch.core.soc import ChipSimulator


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Opt-in per-timestep capture, threaded through ChipSimulator.

    enabled     — emit trace counters from the engines' layer-steps
                  (default off: the run is op-for-op an untraced one).
    skip_words  — also capture per-layer ZSPE skip-word counts.  The
                  fused engine gets these for free; the compiled engine
                  packs each layer's input spikes to count them.
    """

    enabled: bool = False
    skip_words: bool = True


@dataclasses.dataclass
class ChipTrace:
    """One traced run: raw per-step counters + host-derived series.

    Slice axis `S` concatenates every layer's core slices in layer
    order; row `s` describes the slice of placed layer
    `slice_layer[s] + 1` on physical core `slice_core[s]` — the same
    ordering `mapping.cores_of_layer` and the per-layer FlowTables use.
    All arrays are float64 numpy with leading (batch, steps) axes.
    """

    # static metadata
    freq_hz: float
    zero_skip: bool
    partial_update: bool
    pipeline_depth: int
    layer_sizes: tuple            # (L+1,) incl. the input population
    slice_layer: np.ndarray       # (S,) 0-based weight-layer index
    slice_core: np.ndarray        # (S,) physical NoC node id
    slice_neurons: np.ndarray     # (S,) neurons held by the slice
    core_ids: np.ndarray          # (A,) sorted active core node ids
    n_nodes: int

    # raw engine counters (integer-valued)
    fired: np.ndarray             # (B, T, S) spikes fired per slice
    touched: np.ndarray           # (B, T, S) membrane updates per slice
    nnz: np.ndarray               # (B, T, L) input spikes per layer
    skip_words: np.ndarray | None  # (B, T, L) ZSPE skip-word counts
    weight_writes: np.ndarray | None  # (B, T, L) plasticity index writes

    # host-derived series (build_trace, float64, engine-independent)
    cycles: np.ndarray            # (B, T, S) per-slice timestep cycles
    core_cycles: np.ndarray       # (B, T, A) summed per active core
    core_wall: np.ndarray         # (B, T) max over cores (critical path)
    router_load: np.ndarray       # (B, T, n_nodes) spike occupancy
    contention_cycles: np.ndarray  # (B, T) M/M/1 bottleneck wait
    noc_hops: np.ndarray          # (B, T, S) hops charged to source slice
    noc_pj: np.ndarray            # (B, T, S) NoC pJ charged to source slice

    @property
    def batch(self) -> int:
        return int(self.fired.shape[0])

    @property
    def steps(self) -> int:
        return int(self.fired.shape[1])

    @property
    def n_slices(self) -> int:
        return int(self.fired.shape[2])

    @property
    def n_layers(self) -> int:
        return int(self.nnz.shape[2])

    def wall_cycles(self) -> np.ndarray:
        """(B,) total wall clock incl. contention — matches ChipReport."""
        return (self.core_wall + self.contention_cycles).sum(axis=1)

    def validate(self) -> None:
        """Schema self-check: every engine must produce these shapes."""
        B, T, S = self.fired.shape
        L = self.n_layers
        assert self.touched.shape == (B, T, S), self.touched.shape
        assert self.nnz.shape == (B, T, L), self.nnz.shape
        if self.skip_words is not None:
            assert self.skip_words.shape == (B, T, L), self.skip_words.shape
        if self.weight_writes is not None:
            assert self.weight_writes.shape == (B, T, L), \
                self.weight_writes.shape
        assert self.cycles.shape == (B, T, S)
        assert self.core_cycles.shape == (B, T, len(self.core_ids))
        assert self.core_wall.shape == (B, T)
        assert self.router_load.shape == (B, T, self.n_nodes)
        assert self.contention_cycles.shape == (B, T)
        assert self.noc_pj.shape == (B, T, S)
        assert self.noc_hops.shape == (B, T, S)
        assert len(self.slice_layer) == S and len(self.slice_core) == S

    @staticmethod
    def concat(traces: "list[ChipTrace]") -> "ChipTrace":
        """Stack same-schema traces along the batch axis (reference
        engine: one trace per sample)."""
        head = traces[0]
        if len(traces) == 1:
            return head
        cat = {}
        for f in dataclasses.fields(ChipTrace):
            v = getattr(head, f.name)
            if f.name in ("skip_words", "weight_writes"):
                cat[f.name] = (None if v is None else np.concatenate(
                    [getattr(t, f.name) for t in traces], axis=0))
            elif isinstance(v, np.ndarray) and v.ndim >= 2:
                cat[f.name] = np.concatenate(
                    [getattr(t, f.name) for t in traces], axis=0)
            else:
                cat[f.name] = v
        return ChipTrace(**cat)


def slice_metadata(sim: "ChipSimulator"):
    """(slice_layer, slice_core, slice_neurons, n_pre_per_layer) in the
    canonical layer-major slice order shared with the engine lowering."""
    slice_layer, slice_core, slice_neurons, n_pres = [], [], [], []
    for li, w in enumerate(sim.weights):
        n_pres.append(int(w.shape[0]))
        for a in sim.mapping.cores_of_layer(li + 1):
            slice_layer.append(li)
            slice_core.append(a.core_id)
            slice_neurons.append(a.n_neurons)
    return (np.asarray(slice_layer, np.int64),
            np.asarray(slice_core, np.int64),
            np.asarray(slice_neurons, np.int64),
            np.asarray(n_pres, np.int64))


def _slice_cycles(sim: "ChipSimulator", nnz_layer, slice_n, n_pre):
    """Vectorized f64 `CycleModel.timestep_cycles` for one layer's slices.

    `nnz_layer` is (B, T); `slice_n` is (S_li,).  The counters are exact
    integers, so float64 ceil here equals the engines' per-step f32
    `torch.ceil`.
    """
    g = sim.cycle_model.geom
    load = float(-(-n_pre // g.spike_lanes))
    syn_src = nnz_layer[..., None] if sim.zero_skip else float(n_pre)
    syn = np.ceil(syn_src * slice_n / g.spe_lanes)
    return load, syn


def build_trace(sim: "ChipSimulator", fired, touched, nnz,
                skip_words=None, weight_writes=None) -> ChipTrace:
    """Assemble a ChipTrace from an engine's raw counters.

    fired/touched: (B, T, S) per-slice integer counts in layer-major
    slice order; nnz: (B, T, L); skip_words/weight_writes: (B, T, L) or
    None.  `weight_writes` is the plasticity register-write count per
    layer-step (raw counter only — its stage cycles are priced per
    layer-step and core, and its energy by `WeightWriteModel` in the report).  All
    derived series are computed here — identically for every engine.
    """
    fired = np.asarray(fired, np.float64)
    touched = np.asarray(touched, np.float64)
    nnz = np.asarray(nnz, np.float64)
    if skip_words is not None:
        skip_words = np.asarray(skip_words, np.float64)
    if weight_writes is not None:
        weight_writes = np.asarray(weight_writes, np.float64)
    B, T, S = fired.shape
    L = nnz.shape[2]
    slice_layer, slice_core, slice_neurons, n_pres = slice_metadata(sim)
    assert len(slice_layer) == S, (len(slice_layer), S)
    active = np.asarray(sim.mapping.active_core_ids(), np.int64)
    dense = {int(c): i for i, c in enumerate(active)}
    core_index = np.asarray([dense[int(c)] for c in slice_core], np.int64)
    n_nodes = int(sim.adj.shape[0])
    depth = sim.cycle_model.geom.pipeline_depth

    cycles = np.zeros((B, T, S))
    noc_pj = np.zeros((B, T, S))
    noc_hops = np.zeros((B, T, S))
    router_load = np.zeros((B, T, n_nodes))
    for li in range(L):
        sel = np.flatnonzero(slice_layer == li)
        slice_n = slice_neurons[sel].astype(np.float64)
        load, syn = _slice_cycles(sim, nnz[..., li], slice_n, int(n_pres[li]))
        upd = (np.ceil(touched[..., sel]) if sim.partial_update
               else np.broadcast_to(slice_n, (B, T, len(sel))))
        cycles[..., sel] = np.maximum(np.maximum(load, syn), upd) + depth
        if li + 1 < len(sim.weights):
            ft = NOC.compile_flow_table(
                sim._layer_routes[li + 1], sim.router, n_nodes=n_nodes,
                interconnect=sim.interconnect)
            fired_li = fired[..., sel]                    # (B, T, F)
            noc_pj[..., sel] = fired_li * ft.energy_pj
            noc_hops[..., sel] = fired_li * ft.hops.astype(np.float64)
            router_load += fired_li @ ft.router_load.astype(np.float64)

    core_cycles = np.zeros((B, T, len(active)))
    np.add.at(core_cycles.transpose(2, 0, 1), core_index,
              cycles.transpose(2, 0, 1))
    core_wall = core_cycles.max(axis=2)
    contention = np.asarray(NOC.contention_cycles(
        router_load.max(axis=2), core_wall, sim.router), np.float64)

    trace = ChipTrace(
        freq_hz=float(sim.freq_hz), zero_skip=bool(sim.zero_skip),
        partial_update=bool(sim.partial_update), pipeline_depth=int(depth),
        layer_sizes=tuple(int(s) for s in sim.mapping.layer_sizes),
        slice_layer=slice_layer, slice_core=slice_core,
        slice_neurons=slice_neurons, core_ids=active, n_nodes=n_nodes,
        fired=fired, touched=touched, nnz=nnz, skip_words=skip_words,
        weight_writes=weight_writes,
        cycles=cycles, core_cycles=core_cycles, core_wall=core_wall,
        router_load=router_load, contention_cycles=contention,
        noc_hops=noc_hops, noc_pj=noc_pj)
    trace.validate()
    return trace
