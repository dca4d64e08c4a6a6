"""Batched chip engines of the port: a loop over T, an explicit batch axis.

Port of `repro.core.engine` (the sharded engine aside).  Two array
engines share one lowering (`lower_tables`) and one pricing/report stage
(`_EngineBase.run_batch` -> `energy.price_batched`).  NoC accounting is
source-exact: each step emits integer per-core fired counts
(`out @ slice_onehot`) and the host replays them against the per-flow
`noc.FlowTable` vectors in float64, adding the bottleneck router's M/M/1
`contention_cycles` to the wall clock.

* `CompiledEngine` — per layer-step a dense `spikes @ w` against the
  dequantized f32 weights plus `lif_step`.  The product stays
  `torch.matmul`, as the reference leaves it to XLA outside any kernel.
  It is the port's own dense oracle.
* `FusedEngine` — the main path.  Each layer-step is ONE fused-timestep
  kernel (kernels/fused_timestep.py) on bitpacked uint16 16-spike words
  with codebook-compressed weights (int8 indexes + per-column level
  values), zero-skip and the partial-update LIF in the same pass.  On the
  CPU the kernel's plain version runs the whole batch as one tile whose
  float program is the compiled engine's, so at word-aligned widths the
  two engines agree bit-exactly.

`jax.vmap` became the explicit batch axis and `jax.lax.scan` a Python
loop over T.  Per-step counters stay on the device, stacked over T, and
cross to the host once per run for the float64 pricing.

Faults and tracing thread through both engines.  A simulator's
`drop_plan` (faults.DropPlan) multiplies each layer's output spikes by
that step's survival mask before the next layer integrates them (the
counters stay pre-drop: the source fired and paid for the packet); the
masks of a run are drawn once per layer, all T at a time.  An enabled
`TraceConfig` adds per-core fired / touched counters for every layer (and
the compiled engine's skip-word count), from which `run_batch` builds the
run's `ChipTrace`.  With no drop plan and the trace off the engines issue
exactly the ops of a fault-free, untraced build.

On-chip plasticity (`core/plasticity.py`) threads through both engines
as well.  An enabled `PlasticityConfig` lowers each learnable layer to its
register-table indexes (`lower_plasticity_tables`) and carries them, with
the STDP traces and the eligibility, through the run (`PlasticRun`, batch
leading).  A learnable layer leaves the fused kernel, since its weights
are per-sample run state: both engines run it through the same torch
expression, so they learn bit-identical indexes; frozen layers keep the
kernel.  Index writes price into the cycle model's plasticity stage and
the report.  Disabled, the engines issue exactly the inference ops.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core import energy as E
from repro_torch.core import noc as NOC
from repro_torch.core import plasticity as PLC
from repro_torch.core import zspe as Z
from repro_torch.core.neuron import LIFState, init_state, lif_step, touch_mask
from repro_torch.telemetry.trace import build_trace

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (soc -> engine)
    from repro_torch.core.soc import ChipReport, ChipSimulator


@dataclasses.dataclass(frozen=True)
class LayerTables:
    """Array lowering of one layer's core assignments."""

    n_pre: int
    n_post: int
    slice_sizes: np.ndarray    # (A,) neurons held by each core slice
    core_index: np.ndarray     # (A,) dense index into the active-core list
    slice_onehot: np.ndarray   # (n_post, A) f32 neuron -> core-slice indicator


@dataclasses.dataclass(frozen=True)
class EngineTables:
    """Everything the step function closes over, in array form."""

    layers: tuple[LayerTables, ...]
    flows: tuple[NOC.FlowTable | None, ...]   # flows[li]: layer li+1 -> li+2
    n_active_cores: int
    nominal_sops_per_step: int


def lower_tables(sim: "ChipSimulator") -> EngineTables:
    """Lower a simulator's mapping + precompiled routes to pure arrays.

    `slice_onehot` segments a layer's neuron axis into its core slices:
    `out @ slice_onehot` yields integer-exact per-core fired/touched
    counts.  Row `i` of layer `li`'s count vector aligns with row `i` of
    `flows[li]` (both follow `cores_of_layer` assignment order), which is
    what makes the per-flow NoC replay source-exact.
    """
    active = sim.mapping.active_core_ids()
    dense = {cid: i for i, cid in enumerate(active)}
    layers = []
    for li, w in enumerate(sim.weights):
        asn = sim.mapping.cores_of_layer(li + 1)
        n_post = int(w.shape[1])
        onehot = np.zeros((n_post, len(asn)), np.float32)
        for i, a in enumerate(asn):
            onehot[a.neuron_lo:a.neuron_hi, i] = 1.0
        layers.append(LayerTables(
            n_pre=int(w.shape[0]), n_post=n_post,
            slice_sizes=np.array([a.n_neurons for a in asn], np.float32),
            core_index=np.array([dense[a.core_id] for a in asn], np.int32),
            slice_onehot=onehot))
    flows: list[NOC.FlowTable | None] = []
    for li in range(len(sim.weights)):
        if li + 1 < len(sim.weights):
            flows.append(NOC.compile_flow_table(
                sim._layer_routes[li + 1], sim.router,
                n_nodes=sim.adj.shape[0], interconnect=sim.interconnect))
        else:
            flows.append(None)
    nominal = sum(lt.n_pre * lt.n_post for lt in layers)
    return EngineTables(layers=tuple(layers), flows=tuple(flows),
                        n_active_cores=len(active),
                        nominal_sops_per_step=nominal)


@dataclasses.dataclass(frozen=True)
class FusedLayerWeights:
    """One layer's weight operand for the fused kernel.

    Codebook form when every core slice of the layer has a programmed
    `RegisterTable` whose words reproduce the executed weights exactly
    (`idx` int8 indexes + `cbw` per-column level values = words x scale);
    dense f32 otherwise (float-only simulators).  Rows are padded to the
    16-spike word boundary with zeros — bit-neutral, since the padded
    spike bits are zero too.
    """

    n_pre: int
    n_post: int
    kw: int                            # spike words per input row
    idx: torch.Tensor | None           # (kw*16, n_post) int8
    cbw: torch.Tensor | None           # (n_levels, n_post) f32
    dense: torch.Tensor | None         # (kw*16, n_post) f32
    all_nonzero: bool = False          # every real weight element != 0: the
                                       # touch counts are the row popcounts

    @property
    def codebook_mode(self) -> bool:
        return self.idx is not None


def _lower_codebook_layer(sim: "ChipSimulator", li: int, fill: float = 0.0,
                          ) -> tuple[np.ndarray, np.ndarray] | None:
    """Rebuild (idx, cbw) for layer `li` from the per-core RegisterTables.

    Returns None when any slice lacks a programmed table or the table
    words do not reproduce the executed weights bit-exactly — the caller
    then falls back to the dense-weight kernel.  numpy on the host, as in
    the reference, so the indexes are the reference's bit for bit.

    `fill` pads unprogrammed codebook rows (slices whose table holds
    fewer than the layer-max levels).  The fused kernel wants 0.0 (a
    padded row dequantizes to nothing); the plasticity lowering wants
    +inf so `quant.project_to_codebook` can never select a row the
    core's table does not hold.
    """
    w = sim.weights[li].detach().cpu().numpy().astype(np.float32, copy=False)
    n_pre, n_post = w.shape
    # one physical core holds one assignment, so core_id keys the table
    by_core: dict[int, object] = {}
    for rt in sim.register_tables:
        if rt.core_id in by_core:
            return None                                # ambiguous: bail
        by_core[rt.core_id] = rt
    slices = [(a, by_core.get(a.core_id))
              for a in sim.mapping.assignments if a.layer == li + 1]
    if not slices or any(rt is None for _, rt in slices):
        return None
    covered = sum(a.n_neurons for a, _ in slices)
    if covered != n_post:
        return None
    n_levels = max(rt.weight_levels for _, rt in slices)
    idx = np.zeros((n_pre, n_post), np.int8)
    cbw = np.full((n_levels, n_post), fill, np.float32)
    for a, rt in slices:
        if not rt.codebook_words:
            return None
        cb = rt.codebook()                                 # (L,) f32
        cols = w[:, a.neuron_lo:a.neuron_hi]
        ii = np.argmin(np.abs(cols[:, :, None] - cb[None, None, :]), axis=-1)
        if not np.array_equal(cb[ii], cols):
            return None                                    # not table-exact
        idx[:, a.neuron_lo:a.neuron_hi] = ii.astype(np.int8)
        cbw[:len(cb), a.neuron_lo:a.neuron_hi] = cb[:, None]
    return idx, cbw


def lower_plasticity_tables(sim: "ChipSimulator") -> tuple:
    """Per-layer plasticity lowering: None for frozen layers, else the
    (idx0 int8 (n_pre, n_post), cbw f32 (L, n_post)) pair, on the
    simulator's device, whose indexes every engine carries and learns.

    Initial indexes come from the post-fault RegisterTables (faults
    corrupt tables in `ChipSimulator.__init__`, before any lowering), so
    `FaultConfig` codebook corruption lands in the *initial* state only.
    Unprogrammed codebook rows are +inf so projection cannot select them;
    both the argmin here and `project_to_codebook` break ties to the
    lowest index, making every initial index a projection fixed point (a
    zero update never counts as a write).
    """
    cfg = sim.plasticity
    if not cfg.enabled:
        return tuple(None for _ in sim.weights)
    out = []
    for li in range(len(sim.weights)):
        if not cfg.learns(li):
            out.append(None)
            continue
        t = _lower_codebook_layer(sim, li, fill=np.inf)
        if t is None:
            raise ValueError(
                f"plasticity on layer {li} requires table-exact codebook "
                f"register tables (quantized weights, or float weights "
                f"with a quant_cfg) — the chip has no register words to "
                f"write otherwise")
        out.append(tuple(torch.as_tensor(a, device=sim.device) for a in t))
    if not any(t is not None for t in out):
        raise ValueError(
            f"plasticity enabled but layers={cfg.layers} selects none of "
            f"the network's {len(sim.weights)} layers")
    return tuple(out)


def lower_fused_weights(sim: "ChipSimulator") -> tuple[FusedLayerWeights, ...]:
    """Lower every layer to its fused-kernel weight operand (on the
    simulator's device)."""
    out = []
    dev = sim.device
    for li, w in enumerate(sim.weights):
        n_pre, n_post = int(w.shape[0]), int(w.shape[1])
        kw = Z.spike_word_count(n_pre)
        kp = kw * Z.SPIKE_WORD_BITS
        nz = bool((w != 0).all())
        cbk = _lower_codebook_layer(sim, li)
        if cbk is not None:
            idx, cbw = cbk
            idx = np.pad(idx, ((0, kp - n_pre), (0, 0)))
            out.append(FusedLayerWeights(
                n_pre=n_pre, n_post=n_post, kw=kw,
                idx=torch.as_tensor(idx, device=dev),
                cbw=torch.as_tensor(cbw, device=dev), dense=None,
                all_nonzero=nz))
        else:
            dense = torch.nn.functional.pad(
                w.to(torch.float32), (0, 0, 0, kp - n_pre)).contiguous()
            out.append(FusedLayerWeights(
                n_pre=n_pre, n_post=n_post, kw=kw,
                idx=None, cbw=None, dense=dense, all_nonzero=nz))
    return tuple(out)


# ---------------------------------------------------------------------------
# shared execution / pricing stage
# ---------------------------------------------------------------------------

class _EngineBase:
    """Lowering + execution + pricing shared by both array engines.

    Subclasses provide `_run(trains, idx0)`: an f32 (B, T, n_in) tensor
    on the simulator's device, and None or the learnable layers' initial
    indexes -> (per-step counter dict, (B, n_out) output counts), every
    counter shaped (B, T, ...), plus a plastic run's final
    `learned_idx_{li}` (and `elig_{li}`).  `run_batch` prices the
    counters through `energy.price_batched`.
    """

    def __init__(self, sim: "ChipSimulator"):
        self.sim = sim
        self.tables = lower_tables(sim)
        # capture config is fixed at construction (the simulator builds
        # each engine once)
        self.trace = sim.trace
        self.last_trace = None       # ChipTrace of the latest traced run
        self._drop_cache: dict[int, list] = {}
        dev = sim.device
        self._layer_consts = [
            (lt, torch.as_tensor(lt.slice_sizes, device=dev)[None, :],
             torch.as_tensor(lt.core_index, dtype=torch.long, device=dev),
             torch.as_tensor(lt.slice_onehot, device=dev))
            for lt in self.tables.layers]
        self._has_flow = [ft is not None for ft in self.tables.flows]
        # on-chip learning (core/plasticity.py): disabled, a run issues
        # exactly the inference ops
        self.plast = sim.plasticity
        self.plast_tables = sim.plasticity_tables()     # all None if off
        self.last_learned = None     # per-layer learned indexes (B leading)
        self.last_elig = None        # per-layer eligibility (reward mode)

    def _run(self, trains: torch.Tensor, idx0: list | None):
        raise NotImplementedError

    # -- plasticity state plumbing ------------------------------------------

    def _adapt_learned(self, li: int, idx: torch.Tensor) -> torch.Tensor:
        """Engine-layout view of a (B, n_pre, n_post) learned-index tensor
        (the fused engine pads rows to the spike-word boundary)."""
        return idx

    def _initial_learned(self, batch: int, learned) -> list:
        """The per-layer initial-index operand: table idx0 by default,
        overridden per layer by `learned` entries ((n_pre, n_post)
        broadcast over the batch, or per-sample (B, ...))."""
        if learned is not None and len(learned) != len(self.plast_tables):
            raise ValueError(
                f"learned must carry one entry per layer "
                f"({len(self.plast_tables)}), got {len(learned)}")
        out = []
        for li, pt in enumerate(self.plast_tables):
            if pt is None:
                if learned is not None and learned[li] is not None:
                    raise ValueError(
                        f"learned[{li}] given but layer {li} is frozen")
                out.append(None)
                continue
            src = pt[0] if learned is None or learned[li] is None \
                else learned[li]
            base = PLC.as_indexes(src, self.sim.device)
            if base.dim() == 2:
                base = base.expand((batch,) + tuple(base.shape))
            if base.dim() != 3 or int(base.shape[0]) != batch:
                raise ValueError(
                    f"learned[{li}]: expected (n_pre, n_post) or "
                    f"({batch}, n_pre, n_post), got {tuple(base.shape)}")
            # a copy: the run's state never aliases the caller's tensors
            out.append(self._adapt_learned(
                li, base.clone(memory_format=torch.contiguous_format)))
        return out

    def apply_reward(self, reward):
        """Reward-mode trial commit: convert the eligibility the last run
        accumulated into projected index writes, priced per sample."""
        if self.plast.mode != "reward" or self.last_elig is None:
            raise ValueError(
                "apply_reward needs a completed reward-mode run to commit")
        self.last_learned, info = PLC.commit_reward(
            self.plast, self.plast_tables, self.last_learned,
            self.last_elig, reward, self.sim.write_model,
            self.sim.cycle_model)
        self.last_elig = None
        return info

    def _drop_masks(self, steps: int) -> list | None:
        """Per layer the (steps, n_post) f32 survival masks of the
        simulator's drop plan (None for a layer without NoC exposure), or
        None without a plan; drawn once per run length."""
        plan = self.sim.drop_plan
        if plan is None:
            return None
        if steps not in self._drop_cache:
            self._drop_cache[steps] = [
                None if p is None else plan.masks(li, steps, self.sim.device)
                for li, p in enumerate(plan.keep_p)]
        return self._drop_cache[steps]

    def _layer_counters(self, li, nnz, tc, out, wall, step, col_writes=None):
        """Per-core cycles into `wall` and the step's counters of layer li.

        `nnz` (B,) f32 input spikes, `tc` (B, n_post) touched mask, `out`
        (B, n_post) f32 output spikes, `col_writes` None or the (B,
        n_post) f32 index writes per post neuron of an STDP layer-step;
        appends to the `step` lists (a plastic run's step has "writes").
        """
        sim = self.sim
        lt, slices, core_idx, onehot = self._layer_consts[li]
        # integer-exact per-core-slice touched counts: the cycle model
        # ceils them, and exact ints cannot straddle a ceil boundary
        core_touched = tc.to(torch.float32) @ onehot            # (B, A)
        # per-core plasticity-stage occupancy, integer-exact as well
        core_writes = None if col_writes is None else col_writes @ onehot
        core_cyc = sim.cycle_model.timestep_cycles_array(
            lt.n_pre, slices, nnz[:, None], core_touched,
            sim.zero_skip, sim.partial_update, writes=core_writes)
        wall.index_add_(1, core_idx, core_cyc)
        step["nnz"].append(nnz)
        step["touched"].append(tc.sum(-1).to(torch.float32))
        step["fired"].append(out.sum(-1))
        if "writes" in step:
            step["writes"].append(
                torch.zeros_like(nnz) if col_writes is None
                else col_writes.sum(-1))
        if self._has_flow[li] or self.trace.enabled:
            # per-source-core fired counts, row-aligned with the layer's
            # FlowTable; priced exactly on the host
            step[f"fired_core_{li}"] = out @ onehot
        if self.trace.enabled:
            step[f"touched_core_{li}"] = core_touched

    def _collect(self, steps: list[dict]) -> dict:
        """Stack the per-step counters over T -> (B, T, ...) tensors."""
        ys = {}
        for key in steps[0]:
            per_t = [s[key] if not isinstance(s[key], list)
                     else torch.stack(s[key], dim=-1) for s in steps]
            ys[key] = torch.stack(per_t, dim=1)
        return ys

    def run_raw(self, spike_trains, learned=None
                ) -> tuple[dict, torch.Tensor]:
        """Run the engine: per-step counters (on the device) and output
        counts.  `learned` (plasticity only) warm-starts the learnable
        layers' indexes."""
        trains = torch.as_tensor(spike_trains).to(self.sim.device,
                                                  torch.float32)
        if trains.dim() != 3:
            raise ValueError(
                f"expected (batch, T, n_in), got {tuple(trains.shape)}")
        if not self.plast.enabled:
            if learned is not None:
                raise ValueError("learned indexes passed but plasticity "
                                 "is off")
            return self._run(trains, None)
        return self._run(trains, self._initial_learned(int(trains.shape[0]),
                                                       learned))

    def run_batch(self, spike_trains, learned=None
                  ) -> tuple[torch.Tensor, list["ChipReport"]]:
        """(B, T, n_in) spike trains -> ((B, n_out) counts, per-sample
        ChipReports).

        NoC pricing happens here, on the host, in float64: the run emits
        integer-exact per-core fired counts (`fired_core_{li}`) and the
        per-flow replay (`noc.replay_flows_exact`) + the M/M/1 contention
        term (`noc.contention_cycles`) run the reference's f64 arithmetic.
        """
        from repro_torch.core.soc import ChipReport, StepStats

        sim = self.sim
        tbl = self.tables
        ys_dev, out_counts = self.run_raw(spike_trains, learned=learned)
        # injected transient dispatch faults fire HERE: the run happened,
        # the readback is lost (mid-flight), so a retry can succeed
        sim._consume_transient_fault()
        if self.plast.enabled:
            # learned state stays on the device (B leading, global neuron
            # layout) for warm-starting the next run / the reward commit
            self.last_learned = [
                ys_dev.pop(f"learned_idx_{li}") if pt is not None else None
                for li, pt in enumerate(self.plast_tables)]
            if self.plast.mode == "reward":
                self.last_elig = [
                    ys_dev.pop(f"elig_{li}") if pt is not None else None
                    for li, pt in enumerate(self.plast_tables)]
        # the one device -> host crossing of the run's counters
        ys = {k: v.cpu().numpy().astype(np.float64) for k, v in ys_dev.items()}
        B, T = ys["wall"].shape
        writes = ys.pop("writes", None)                  # (B, T, L)
        writes_total = (writes.sum(axis=(1, 2)) if writes is not None
                        else np.zeros(B))

        n_posts = np.array([lt.n_post for lt in tbl.layers], np.float64)
        nnz = ys["nnz"]                                  # (B, T, L)
        spikes_in = nnz.sum(axis=(1, 2))
        performed = (nnz * n_posts).sum(axis=(1, 2))
        neurons_touched = ys["touched"].sum(axis=(1, 2))
        core_wall = ys["wall"]                           # (B, T) core-only
        skipped_words = (ys["skip_words"].sum(axis=(1, 2))
                         if "skip_words" in ys else np.zeros(B))
        nominal = float(tbl.nominal_sops_per_step) * T

        # exact per-flow NoC replay: counts are integers, pricing is f64
        noc_hops = np.zeros(B)
        noc_pj = np.zeros(B)
        routed = np.zeros(B)
        load = np.zeros((B, T, sim.adj.shape[0]))
        for li, ft in enumerate(tbl.flows):
            if ft is None:
                continue
            fired_core = ys[f"fired_core_{li}"]
            h, e, ld = NOC.replay_flows_exact(ft, fired_core)  # (B, T, ...)
            noc_hops += h.sum(axis=1)
            noc_pj += e.sum(axis=1)
            load += ld
            routed += fired_core.sum(axis=(1, 2))
        contention = NOC.contention_cycles(
            load.max(axis=2), core_wall, sim.router)     # (B, T)
        wall = (core_wall + contention).sum(axis=1)
        noc_contention = contention.sum(axis=1)

        if self.trace.enabled:
            # every derived series (cycles, router load, contention) is
            # recomputed on the host by build_trace from these integer
            # counters — one implementation for both engines
            L = len(tbl.layers)
            self.last_trace = build_trace(
                sim,
                np.concatenate([ys[f"fired_core_{li}"] for li in range(L)],
                               axis=-1),
                np.concatenate([ys[f"touched_core_{li}"] for li in range(L)],
                               axis=-1),
                nnz,
                (ys["skip_words"]
                 if self.trace.skip_words and "skip_words" in ys else None),
                weight_writes=writes)

        priced = E.price_batched(
            sim.core_model, sim.riscv,
            nominal_sops=np.full(B, nominal), performed_sops=performed,
            noc_energy_pj=noc_pj, wall_cycles=wall, steps=T,
            freq_hz=sim.freq_hz, zero_skip=sim.zero_skip,
            partial_update=sim.partial_update,
            weight_writes=writes_total, write_model=sim.write_model)

        reports = []
        for b in range(B):
            acc = StepStats(
                nominal_sops=nominal,
                performed_sops=float(performed[b]),
                spikes_in=float(spikes_in[b]),
                spikes_routed=float(routed[b]),
                neurons_touched=float(neurons_touched[b]),
                noc_hops=float(noc_hops[b]),
                noc_energy_pj=float(noc_pj[b]),
                noc_contention_cycles=float(noc_contention[b]),
                spike_words_skipped=float(skipped_words[b]),
                weight_writes=float(writes_total[b]),
            )
            reports.append(ChipReport(
                steps=T, stats=acc,
                energy_pj=float(priced["total_pj"][b]),
                core_energy_pj=float(priced["core_pj"][b]),
                noc_energy_pj=float(noc_pj[b]),
                riscv_energy_pj=float(priced["riscv_pj"][b]),
                wall_cycles=float(wall[b]), freq_hz=sim.freq_hz,
                write_energy_pj=float(priced["write_pj"][b])))
        return out_counts, reports

    def run(self, spike_train, learned=None
            ) -> tuple[torch.Tensor, "ChipReport"]:
        """Single-sample convenience wrapper (batch of 1)."""
        counts, reports = self.run_batch(torch.as_tensor(spike_train)[None],
                                         learned=learned)
        return counts[0], reports[0]


def _new_step(plastic: bool = False) -> dict:
    step = {"nnz": [], "touched": [], "fired": []}
    if plastic:
        step["writes"] = []
    return step


class PlasticRun:
    """The learnable layers' state through one plastic run (indexes,
    traces, eligibility; batch leading) and their layer-step.

    Every engine runs a learnable layer through `step`, one torch
    expression: the per-column dequant gather of the carried indexes, the
    batched products, `lif_step` and the rule (the reference engine with a
    batch of one).  So at word-aligned widths the fused and compiled
    engines learn bit-identical indexes, and the reference engine those of
    the compiled engine run a sample at a time.  `idx0` holds each
    layer's None or (B, rows, n_post) initial indexes; `rows[li]` is the
    engine's pre-synaptic width (the fused engine pads to the spike-word
    boundary; padded rows never see a spike and their pre-trace stays 0,
    so they never write).
    """

    def __init__(self, sim: "ChipSimulator", idx0: list, rows: list[int]):
        self.cfg = sim.plasticity
        self.cbws = [None if pt is None else pt[1]
                     for pt in sim.plasticity_tables()]
        self.idx = list(idx0)
        self.n_pre = [int(w.shape[0]) for w in sim.weights]
        reward = self.cfg.mode == "reward"

        def zeros(li, *shape):
            return (None if idx0[li] is None else torch.zeros(
                (int(idx0[li].shape[0]),) + shape, device=sim.device))

        n_posts = [int(w.shape[1]) for w in sim.weights]
        self.x_pre = [zeros(li, rows[li]) for li in range(len(rows))]
        self.x_post = [zeros(li, n) for li, n in enumerate(n_posts)]
        self.elig = [zeros(li, rows[li], n) if reward else None
                     for li, n in enumerate(n_posts)]

    def learns(self, li: int) -> bool:
        return self.cbws[li] is not None

    def step(self, li: int, spikes: torch.Tensor, state: LIFState, lif):
        """One learnable layer-step on (B, rows) f32 spikes -> (state',
        out, touched, None or the (B, n_post) f32 writes per post neuron)."""
        cfg = self.cfg
        # live weights from the carried indexes — the chip's SPEs
        # dequantizing the current register state
        w = PLC.dequant_indices(self.idx[li], self.cbws[li])
        current = torch.einsum("bk,bkn->bn", spikes, w)
        nzw = (w != 0).to(torch.float32)
        touched = torch.einsum("bk,bkn->bn", spikes, nzw) > 0
        del w, nzw
        state, out, tc = lif_step(state, current, lif, touched=touched)
        if cfg.mode == "reward":
            self.x_pre[li], self.x_post[li], self.elig[li] = PLC.elig_step(
                cfg, spikes, out, self.x_pre[li], self.x_post[li],
                self.elig[li])
            return state, out, tc, None
        self.idx[li], self.x_pre[li], self.x_post[li], changed = \
            PLC.stdp_step(cfg, spikes, out, self.x_pre[li], self.x_post[li],
                          self.idx[li], self.cbws[li])
        return state, out, tc, changed.sum(-2).to(torch.float32)

    def finals(self) -> dict:
        """The run's final learned indexes (and eligibilities), rows
        cropped back to each layer's n_pre."""
        out = {}
        for li, cbw in enumerate(self.cbws):
            if cbw is None:
                continue
            out[f"learned_idx_{li}"] = self.idx[li][:, :self.n_pre[li]]
            if self.cfg.mode == "reward":
                out[f"elig_{li}"] = self.elig[li][:, :self.n_pre[li]]
        return out


class CompiledEngine(_EngineBase):
    """Dense engine: `spikes @ w` + `lif_step` per layer-step, the batch
    as an explicit axis.  Spike semantics are the reference
    CompiledEngine's; it is the port's own oracle for the fused engine."""

    def _run(self, trains, idx0):
        sim = self.sim
        B, T, _ = trains.shape
        states = [init_state(int(w.shape[1]), (B,), sim.device)
                  for w in sim.weights]
        learn = (None if idx0 is None else PlasticRun(
            sim, idx0, [lt.n_pre for lt in self.tables.layers]))
        n_active = self.tables.n_active_cores
        out_counts = torch.zeros((B, int(sim.weights[-1].shape[1])),
                                 device=sim.device)
        drop = self._drop_masks(T)
        trace_skips = self.trace.enabled and self.trace.skip_words
        steps = []
        for t in range(T):
            spikes = trains[:, t].contiguous()
            wall = torch.zeros((B, n_active), device=sim.device)
            step = _new_step(learn is not None)
            skips = []
            for li, w in enumerate(sim.weights):
                nnz = (spikes != 0).sum(-1).to(torch.float32)
                if trace_skips:
                    # ZSPE skip telemetry on the layer's input spikes,
                    # packed as the fused engine's native counter packs
                    skips.append(Z.empty_spike_words(
                        Z.pack_spike_words(spikes)).to(torch.float32))
                col_writes = None
                if learn is not None and learn.learns(li):
                    states[li], out, touched, col_writes = learn.step(
                        li, spikes, states[li], sim.lif)
                else:
                    current = spikes @ w
                    states[li], out, touched = lif_step(
                        states[li], current, sim.lif,
                        touched=touch_mask(spikes, sim.nonzero_weights[li]))
                self._layer_counters(li, nnz, touched, out, wall, step,
                                     col_writes)
                # counters above are pre-drop; the next layer integrates
                # what survived the hops
                spikes = (out if drop is None or drop[li] is None
                          else out * drop[li][t])
            if trace_skips:
                step["skip_words"] = skips
            step["wall"] = wall.amax(-1)
            out_counts += spikes
            steps.append(step)
        ys = self._collect(steps)
        if learn is not None:
            ys.update(learn.finals())
        return ys, out_counts


class FusedEngine(_EngineBase):
    """The main path: one fused-timestep kernel per layer-step.

    Spikes travel bitpacked (uint16 16-spike words) through the whole run
    — the input train is packed once, each layer's output spikes are
    re-packed for the next layer — and weights stay codebook-compressed
    whenever the simulator's register tables reproduce the executed
    weights exactly.
    """

    def __init__(self, sim: "ChipSimulator"):
        if sim.lif.reset_mode != "hard":
            raise ValueError(
                "FusedEngine supports hard reset only (the chip's updater); "
                f"got reset_mode={sim.lif.reset_mode!r} — use "
                "engine='compiled'")
        super().__init__(sim)
        self.fused_weights = lower_fused_weights(sim)

    @property
    def codebook_layers(self) -> int:
        return sum(lw.codebook_mode for lw in self.fused_weights)

    def _layer_apply(self, lw: FusedLayerWeights, packed, state: LIFState):
        from repro_torch.kernels.fused_timestep import (
            fused_timestep_codebook, fused_timestep_dense)

        lif = self.sim.lif
        kw = dict(threshold=float(lif.threshold), leak=float(lif.leak),
                  reset=float(lif.reset),
                  partial_update=bool(lif.partial_update),
                  all_nonzero=lw.all_nonzero)
        if lw.codebook_mode:
            return fused_timestep_codebook(packed, lw.idx, lw.cbw, state.v,
                                           state.elapsed, **kw)
        return fused_timestep_dense(packed, lw.dense, state.v, state.elapsed,
                                    **kw)

    def _adapt_learned(self, li: int, idx: torch.Tensor) -> torch.Tensor:
        """Pad learned-index rows to the spike-word boundary."""
        lw = self.fused_weights[li]
        return torch.nn.functional.pad(
            idx, (0, 0, 0, lw.kw * Z.SPIKE_WORD_BITS - lw.n_pre))

    def _run(self, trains, idx0):
        sim = self.sim
        B, T, _ = trains.shape
        fused_w = self.fused_weights
        # learnable layers leave the kernel: their weights are per-sample
        # run state (`PlasticRun.step`); frozen layers keep the kernel
        learn = (None if idx0 is None else PlasticRun(
            sim, idx0, [lw.kw * Z.SPIKE_WORD_BITS for lw in fused_w]))
        # the kernel updates v and elapsed in place (the reference donates
        # these buffers to XLA for the same effect), so one allocation per
        # layer serves the whole run
        states = [init_state(lw.n_post, (B,), sim.device) for lw in fused_w]
        n_active = self.tables.n_active_cores
        out_counts = torch.zeros((B, fused_w[-1].n_post), device=sim.device)
        packed_t = Z.pack_spike_words(trains.transpose(0, 1))  # (T, B, kw0)
        drop = self._drop_masks(T)
        steps = []
        for t in range(T):
            packed = packed_t[t]
            wall = torch.zeros((B, n_active), device=sim.device)
            step = _new_step(learn is not None)
            skips = []
            for li, lw in enumerate(fused_w):
                if learn is not None and learn.learns(li):
                    s = Z.unpack_spike_words(packed)           # (B, kp)
                    states[li], out, tc, col_writes = learn.step(
                        li, s, states[li], sim.lif)
                    self._layer_counters(li, (s != 0).sum(-1).to(
                        torch.float32), tc, out, wall, step, col_writes)
                    skips.append(Z.empty_spike_words(packed).to(
                        torch.float32))
                else:
                    _, _, out, tc, nnz_rows, ew = self._layer_apply(
                        lw, packed, states[li])
                    self._layer_counters(li, nnz_rows[:, 0].to(
                        torch.float32), tc, out, wall, step)
                    skips.append(ew[:, 0].to(torch.float32))
                # counters above are pre-drop; the next layer's spike
                # words carry only the packets that survived the hops
                nxt = (out if drop is None or drop[li] is None
                       else out * drop[li][t])
                packed = Z.pack_spike_words(nxt)   # next layer's spike words
            step["skip_words"] = skips
            step["wall"] = wall.amax(-1)
            out_counts += out
            steps.append(step)
        ys = self._collect(steps)
        if learn is not None:
            ys.update(learn.finals())
        return ys, out_counts
