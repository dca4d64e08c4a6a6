"""Batched chip engines of the port: a loop over T, an explicit batch axis.

Port of `repro.core.engine`.  Three array engines share one lowering
(`lower_tables`) and one pricing/report stage (`_EngineBase.run_batch` ->
`energy.price_batched`).  NoC accounting is
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
* `ShardedEngine` — the paper's scale-up: a board of several fullerene
  domains joined through level-2 routers, one block of domains per
  process of a `torch.distributed` group.  Each rank keeps only its
  shard's weight columns (`spikes @ w_local`, `torch.matmul` as in the
  compiled engine) and LIF state; after every layer-step the shards
  exchange their output spikes as packed 16-spike words and sum their
  integer per-core counters, so `run_batch` prices exactly as for the
  other engines.

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

Sharding is SPMD over the default process group: every rank calls the
same `run_batch`.  The reference's single-controller `shard_map` over
`jax.devices()` becomes one process per device; without an initialised
group the world is one process and no engine makes a `torch.distributed`
call.  With a group, the compiled and fused engines split the batch
evenly over the ranks (when it divides) and all-gather the results; the
sharded engine lays the ranks out as a (batch rows) x (cores shards)
mesh.  Every tensor crosses a collective as its `torch.uint8` bytes or,
for the counters' sums, as int64: gloo refuses 16-bit integers in
`all_gather` and NCCL has no 16-bit integer type, and the spike words
are uint16.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch
import torch.distributed as dist

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

    def hbm_bytes_per_step(self, batch: int) -> int:
        """Weight + input-spike HBM traffic for one timestep at `batch`:
        the int8 indexes and f32 level values (or the f32 dense weights)
        and the batch's uint16 spike words."""
        spikes = batch * self.kw * 2
        if self.codebook_mode:
            return self.idx.numel() + self.cbw.numel() * 4 + spikes
        return self.dense.numel() * 4 + spikes


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
# process-group plumbing: batch and cores sharding
# ---------------------------------------------------------------------------

def _grouped() -> bool:
    """Whether a default process group is initialised; without one the
    engines make no collective call."""
    return dist.is_available() and dist.is_initialized()


def _world() -> tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    if not _grouped():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def _subgroup(ranks_per_group: list[list[int]]):
    """This rank's group among `ranks_per_group`, which partitions the
    world: None (the default group) when one group holds every rank, else
    `dist.new_subgroups_by_enumeration`, which every rank must enter in
    the same order (the engines build theirs at construction)."""
    if len(ranks_per_group) == 1:
        return None
    group, _ = dist.new_subgroups_by_enumeration(ranks_per_group)
    return group


def _all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of integer-valued f32 counters over `group`, exact: the values
    cross as int64."""
    if not _grouped():
        return t
    x = t.to(torch.int64)
    dist.all_reduce(x, group=group)
    return x.to(t.dtype)


def _all_gather_bytes(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's `t` of `group`, in rank order.  The tensor crosses as
    its `torch.uint8` bytes whatever its dtype: gloo rejects int16 and
    uint16 in `all_gather` ("Invalid scalar type") and NCCL has no 16-bit
    integer, and the spike words are uint16."""
    if not _grouped():
        return [t]
    b = t.contiguous().view(torch.uint8)
    out = [torch.empty_like(b) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, b, group=group)
    return [o.view(t.dtype) for o in out]


def _gather_rows(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """All-gather (rows, ...) tensors along dim 0 over `group` (each
    rank's shapes equal), all of them in one byte buffer: the widest
    dtype first, so every tensor's bytes start aligned to its size."""
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    flat = torch.cat([tensors[i].contiguous().view(torch.uint8).reshape(-1)
                      for i in order])
    parts = _all_gather_bytes(flat, group)
    out: list = [None] * len(tensors)
    at = 0
    for i in order:
        t = tensors[i]
        n = t.numel() * t.element_size()
        out[i] = torch.cat([p[at:at + n].view(t.dtype).view(t.shape)
                            for p in parts])
        at += n
    return out


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

    With `shard` on and a process group initialised, a batch that the
    world size divides runs B / world rows on each rank, and the results
    are all-gathered (`_batch_plan`, `last_run_sharded`); the bytes a run
    moves through collectives are in `last_exchange_bytes`.
    """

    def __init__(self, sim: "ChipSimulator", shard: bool = True):
        self.sim = sim
        self.shard = shard
        self.last_run_sharded = False
        self.last_exchange_bytes = 0     # bytes each rank sent in the run
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

    def _initial_learned(self, batch: int, learned, rows=slice(None)
                         ) -> list:
        """The per-layer initial-index operand: table idx0 by default,
        overridden per layer by `learned` entries ((n_pre, n_post)
        broadcast over the batch, or per-sample (B, ...)); `rows` picks
        this rank's rows of a sharded batch."""
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
                li, base[rows].clone(memory_format=torch.contiguous_format)))
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

    def _core_cycles(self, li, nnz, core_touched, core_writes, wall):
        """Add layer li's per-core cycles of one step into `wall` (B,
        n_active) from its (B, A) per-core touched / writes counts."""
        sim = self.sim
        lt, slices, core_idx, _ = self._layer_consts[li]
        core_cyc = sim.cycle_model.timestep_cycles_array(
            lt.n_pre, slices, nnz[:, None], core_touched,
            sim.zero_skip, sim.partial_update, writes=core_writes)
        wall.index_add_(1, core_idx, core_cyc)

    def _layer_counters(self, li, nnz, tc, out, wall, step, col_writes=None):
        """Per-core cycles into `wall` and the step's counters of layer li.

        `nnz` (B,) f32 input spikes, `tc` (B, n_post) touched mask, `out`
        (B, n_post) f32 output spikes, `col_writes` None or the (B,
        n_post) f32 index writes per post neuron of an STDP layer-step;
        appends to the `step` lists (a plastic run's step has "writes").
        """
        onehot = self._layer_consts[li][3]
        # integer-exact per-core-slice touched counts: the cycle model
        # ceils them, and exact ints cannot straddle a ceil boundary
        core_touched = tc.to(torch.float32) @ onehot            # (B, A)
        # per-core plasticity-stage occupancy, integer-exact as well
        core_writes = None if col_writes is None else col_writes @ onehot
        self._core_cycles(li, nnz, core_touched, core_writes, wall)
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
        if learned is not None and not self.plast.enabled:
            raise ValueError("learned indexes passed but plasticity is off")
        batch = int(trains.shape[0])
        rows, group, self.last_run_sharded = self._batch_plan(batch)
        self.last_exchange_bytes = 0
        idx0 = (self._initial_learned(batch, learned, rows)
                if self.plast.enabled else None)
        ys, out_counts = self._run(trains[rows], idx0)
        if group is False:
            return ys, out_counts
        keys = sorted(ys)
        mine = [ys[k] for k in keys] + [out_counts]
        self.last_exchange_bytes += sum(t.numel() * t.element_size()
                                        for t in mine)
        got = _gather_rows(mine, group)
        return dict(zip(keys, got[:-1])), got[-1]

    def _batch_plan(self, batch: int):
        """(this rank's rows, the group gathering them or False when
        nothing is gathered, whether the batch is split over ranks).
        Compiled and fused: with `shard` on and a group initialised, the
        world size divides the batch -> B / world rows a rank, gathered
        over the default group (so at world size 1 too)."""
        world, rank = _world()
        if not (self.shard and _grouped() and batch % world == 0):
            return slice(None), False, False
        b = batch // world
        return slice(rank * b, (rank + 1) * b), None, world > 1

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
    so they never write).  The sharded engine passes its shard's columns:
    `cbws` (per layer None or the (L, width) level sets, padded columns
    [0, inf, ...]) with idx0 of that width.
    """

    def __init__(self, sim: "ChipSimulator", idx0: list, rows: list[int],
                 cbws: list | None = None):
        self.cfg = sim.plasticity
        self.cbws = (cbws if cbws is not None else
                     [None if pt is None else pt[1]
                      for pt in sim.plasticity_tables()])
        self.idx = list(idx0)
        self.n_pre = [int(w.shape[0]) for w in sim.weights]
        reward = self.cfg.mode == "reward"

        def zeros(li, *shape):
            return (None if idx0[li] is None else torch.zeros(
                (int(idx0[li].shape[0]),) + shape, device=sim.device))

        n_posts = [int(w.shape[1]) if c is None else int(c.shape[1])
                   for w, c in zip(sim.weights, self.cbws)]
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


def n_domains_of(mapping) -> int:
    """Fullerene domains a mapping spans (1 unless the compiler's scale-up
    placed cores beyond the first domain)."""
    max_node = max(a.core_id for a in mapping.assignments)
    return (max_node // NOC.DOMAIN_STRIDE + 1 if max_node >= NOC.N_NODES
            else 1)


def shard_of_core(core_id: int, n_shards: int, n_domains: int) -> int:
    """Domains map contiguously onto shards."""
    dom = core_id // NOC.DOMAIN_STRIDE if core_id >= NOC.N_NODES else 0
    return dom * n_shards // n_domains


@dataclasses.dataclass(frozen=True)
class ShardedLayer:
    """One shard's cores-axis lowering of one layer.

    `w` / `nzw` hold the shard's owned weight columns (gathered by neuron
    ownership, zero-padded to the common width `width` of every shard),
    `onehot` the matching rows of the layer's slice-onehot, and `pos`
    maps every global neuron id to its lane in the all-gathered bit
    vector (shard * 16*words + local index).  Every core's neuron slice
    lives wholly inside one shard, so per-core counters are exact partial
    sums.  A learnable layer adds `cbw`, the owned columns' level sets
    (padded columns [0, inf, ...], whose index 0 is a projection fixed
    point with no traffic, so a pad never writes), and `colpos`, which
    reassembles all-gathered local columns into global order (shard *
    width + lane).
    """

    width: int                    # padded neurons per shard
    words: int                    # uint16 spike words per shard
    owned: torch.Tensor           # (n_owned,) long, ascending global ids
    w: torch.Tensor               # (n_pre, width) f32
    nzw: torch.Tensor             # (n_pre, width) f32
    onehot: torch.Tensor          # (width, A) f32
    pos: torch.Tensor             # (n_post,) long gather into S*words*16 bits
    cbw: torch.Tensor | None      # (L, width) f32, learnable layers only
    colpos: torch.Tensor | None   # (n_post,) long, learnable layers only


def lower_shard(sim: "ChipSimulator", tables: EngineTables, n_shards: int,
                n_domains: int, shard: int, plast_tables=None
                ) -> tuple[ShardedLayer, ...]:
    """Shard `shard`'s column blocks of every layer, on the simulator's
    device: a rank holds its own shard only.  `plast_tables` (the
    simulator's plasticity lowering) adds the learnable layers' level
    sets.  A shard that owns every column keeps the simulator's own
    tensors."""
    dev = sim.device
    out = []
    for li, w in enumerate(sim.weights):
        lt = tables.layers[li]
        owner = np.zeros(lt.n_post, np.int64)
        for a in sim.mapping.cores_of_layer(li + 1):
            owner[a.neuron_lo:a.neuron_hi] = shard_of_core(
                a.core_id, n_shards, n_domains)
        owned = [np.flatnonzero(owner == s) for s in range(n_shards)]
        width = max(int(o.size) for o in owned)
        words = Z.spike_word_count(max(width, 1))
        pos = np.zeros(lt.n_post, np.int64)
        colpos = np.zeros(lt.n_post, np.int64)
        for s, o in enumerate(owned):
            pos[o] = s * words * Z.SPIKE_WORD_BITS + np.arange(o.size)
            colpos[o] = s * width + np.arange(o.size)
        mine = owned[shard]
        k = int(mine.size)
        cols = torch.as_tensor(mine, device=dev)
        pt = None if plast_tables is None else plast_tables[li]
        cbw = None
        if k == lt.n_post:                       # every column, in order
            w_l, nzw_l = w, sim.nonzero_weights[li]
            onehot = torch.as_tensor(lt.slice_onehot, device=dev)
            if pt is not None:
                cbw = pt[1]
        else:
            w_l = torch.zeros((lt.n_pre, width), device=dev)
            w_l[:, :k] = w[:, cols]
            nzw_l = torch.zeros((lt.n_pre, width), device=dev)
            nzw_l[:, :k] = sim.nonzero_weights[li][:, cols]
            onehot = torch.zeros((width, lt.slice_onehot.shape[1]),
                                 device=dev)
            onehot[:k] = torch.as_tensor(lt.slice_onehot[mine], device=dev)
            if pt is not None:
                cbw = torch.full((pt[1].shape[0], width), torch.inf,
                                 device=dev)
                cbw[0] = 0.0
                cbw[:, :k] = pt[1][:, cols]
        out.append(ShardedLayer(
            width=width, words=words, owned=cols, w=w_l, nzw=nzw_l,
            onehot=onehot, pos=torch.as_tensor(pos, device=dev),
            cbw=cbw, colpos=(None if pt is None
                             else torch.as_tensor(colpos, device=dev))))
    return tuple(out)


class ShardedEngine(_EngineBase):
    """Cores-axis engine: a multi-domain board as one SPMD program over
    the ranks of the default process group.

    Domains map contiguously onto `n_shards` shards; rank r holds shard
    r % S of batch row r // S (`n_rows` = world / S rows).  A rank keeps
    only its shard's weight columns (`spikes @ w_local`, `torch.matmul`
    as in the compiled engine) and its slice of the LIF state.  After
    each layer-step the shard packs its output spikes into uint16 words
    (`zspe.pack_spike_words`) and all-gathers them, as bytes, over its
    row's cores group: the domain-boundary spike traffic, 16 spikes per
    word; the bits then go back into global neuron order for the next
    layer's fan-in, and the drop plan applies after the gather (`fired`
    counts before it).  Per-core counters (touched, fired, writes) are
    exact integer partial sums, summed over the cores group, so
    `_EngineBase.run_batch` prices NoC, contention and energy through the
    same host f64 pipeline as the other engines.  A learnable layer
    learns on the shard's own index columns (`PlasticRun` with the
    shard's level sets); the final indexes and eligibilities are gathered
    back into global order.

    Composes with batch sharding: with `shard` on and a batch that the
    rows divide, each row runs B / n_rows samples and the results are
    all-gathered over the shard's batch group; otherwise every row runs
    the whole batch.  `n_shards` defaults to the largest divisor of the
    world size not above min(world, n_domains) — the reference's
    min(devices, domains) would leave ranks without a place, which one
    SPMD program cannot hold — and a single-domain mapping, or one
    process, degenerates to S = 1, where the shard is the whole matrix in
    the compiled engine's column order.  Groups are created here, so
    every rank must build its engines in the same order.
    """

    def __init__(self, sim: "ChipSimulator", shard: bool = True,
                 n_shards: int | None = None):
        super().__init__(sim, shard=shard)
        self.n_domains = n_domains_of(sim.mapping)
        world, rank = _world()
        if n_shards is None:
            n_shards = max(1, min(world, self.n_domains))
            while world % n_shards:
                n_shards -= 1
        if not 1 <= n_shards <= world:
            raise ValueError(f"n_shards={n_shards} needs 1..{world} devices")
        if n_shards > self.n_domains:
            raise ValueError(
                f"n_shards={n_shards} exceeds the mapping's "
                f"{self.n_domains} domain(s) — shards split on domain "
                f"boundaries")
        if world % n_shards:
            raise ValueError(
                f"n_shards={n_shards} must divide the world size {world}: "
                f"every rank holds one shard of one batch row")
        S = self.n_shards = n_shards
        self.n_rows = world // S
        self.shard_index, self.batch_row = rank % S, rank // S
        # the exchange groups: a batch row's shards, and a shard's rows
        # (False: no batch gather, as one row has nothing to gather)
        self._cores_group = self._batch_group = None
        if _grouped():
            self._cores_group = _subgroup(
                [[r * S + s for s in range(S)] for r in range(self.n_rows)])
            self._batch_group = (
                _subgroup([[r * S + s for r in range(self.n_rows)]
                           for s in range(S)])
                if S == 1 or self.n_rows > 1 else False)
        self.sharded_layers = lower_shard(
            sim, self.tables, S, self.n_domains, self.shard_index,
            self.plast_tables if self.plast.enabled else None)

    def _batch_plan(self, batch: int):
        """Rows of the batch when the mesh's rows divide it (gathered over
        the shard's batch group), else the whole batch on every row."""
        if not (self.shard and _grouped()
                and self._batch_group is not False
                and batch % self.n_rows == 0):
            return slice(None), False, self.n_shards > 1
        b = batch // self.n_rows
        r = self.batch_row
        return (slice(r * b, (r + 1) * b), self._batch_group,
                self.n_shards > 1 or self.n_rows > 1)

    def _local_columns(self, li: int, g: torch.Tensor) -> torch.Tensor:
        """(B, n_pre, n_post) global learned indexes -> this shard's (B,
        n_pre, width) columns (pads index 0)."""
        if self.n_shards == 1:
            return g
        sl = self.sharded_layers[li]
        out = g.new_zeros(tuple(g.shape[:-1]) + (sl.width,))
        out[..., :sl.owned.numel()] = g[..., sl.owned]
        return out

    def _gather_cores(self, t: torch.Tensor) -> torch.Tensor:
        """Every shard's `t` of this row, concatenated on the last axis in
        shard order."""
        if _grouped():
            self.last_exchange_bytes += t.numel() * t.element_size()
        return torch.cat(_all_gather_bytes(t, self._cores_group), dim=-1)

    def _exchange(self, li, nnz, tc, out, col_writes, wall, step):
        """Layer li's step counters from this shard's (B, width) touched
        mask, spikes and writes, summed over the cores group; returns the
        layer's (B, n_post) spikes in global order."""
        sl = self.sharded_layers[li]
        parts = [tc.to(torch.float32) @ sl.onehot, out @ sl.onehot]
        if col_writes is not None:
            parts.append(col_writes @ sl.onehot)
        red = _all_sum(torch.stack(parts), self._cores_group)  # (k, B, A)
        core_touched = red[0]
        core_writes = red[2] if col_writes is not None else None
        self._core_cycles(li, nnz, core_touched, core_writes, wall)
        # domain-boundary exchange: 16 spikes per uint16 word
        gathered = self._gather_cores(Z.pack_spike_words(out))
        spikes = Z.unpack_spike_words(gathered)[:, sl.pos]
        step["nnz"].append(nnz)
        step["touched"].append(core_touched.sum(-1))
        step["fired"].append(spikes.sum(-1))
        if "writes" in step:
            step["writes"].append(torch.zeros_like(nnz) if core_writes
                                  is None else core_writes.sum(-1))
        if self._has_flow[li] or self.trace.enabled:
            step[f"fired_core_{li}"] = red[1]
        if self.trace.enabled:
            step[f"touched_core_{li}"] = core_touched
        return spikes

    def _run(self, trains, idx0):
        sim = self.sim
        B, T, _ = trains.shape
        shl = self.sharded_layers
        states = [init_state(sl.width, (B,), sim.device) for sl in shl]
        learn = (None if idx0 is None else PlasticRun(
            sim, [None if i is None else self._local_columns(li, i)
                  for li, i in enumerate(idx0)],
            [lt.n_pre for lt in self.tables.layers],
            cbws=[sl.cbw for sl in shl]))
        n_active = self.tables.n_active_cores
        out_counts = torch.zeros((B, self.tables.layers[-1].n_post),
                                 device=sim.device)
        drop = self._drop_masks(T)
        trace_skips = self.trace.enabled and self.trace.skip_words
        steps = []
        for t in range(T):
            spikes = trains[:, t].contiguous()
            wall = torch.zeros((B, n_active), device=sim.device)
            step = _new_step(learn is not None)
            skips = []
            for li, sl in enumerate(shl):
                nnz = (spikes != 0).sum(-1).to(torch.float32)
                if trace_skips:
                    skips.append(Z.empty_spike_words(
                        Z.pack_spike_words(spikes)).to(torch.float32))
                col_writes = None
                if learn is not None and learn.learns(li):
                    states[li], out, touched, col_writes = learn.step(
                        li, spikes, states[li], sim.lif)
                else:
                    current = spikes @ sl.w                  # (B, width)
                    states[li], out, touched = lif_step(
                        states[li], current, sim.lif,
                        touched=touch_mask(spikes, sl.nzw))
                spikes = self._exchange(li, nnz, touched, out, col_writes,
                                        wall, step)
                # counters above are pre-drop; the next layer integrates
                # what survived the hops
                if drop is not None and drop[li] is not None:
                    spikes = spikes * drop[li][t]
            if trace_skips:
                step["skip_words"] = skips
            step["wall"] = wall.amax(-1)
            out_counts += spikes
            steps.append(step)
        ys = self._collect(steps)
        if learn is not None:
            for key, loc in learn.finals().items():
                g = self._gather_cores(loc)
                ys[key] = (g if self.n_shards == 1 else
                           g[..., shl[int(key.rsplit("_", 1)[1])].colpos])
        return ys, out_counts


class FusedEngine(_EngineBase):
    """The main path: one fused-timestep kernel per layer-step.

    Spikes travel bitpacked (uint16 16-spike words) through the whole run
    — the input train is packed once, each layer's output spikes are
    re-packed for the next layer — and weights stay codebook-compressed
    whenever the simulator's register tables reproduce the executed
    weights exactly.
    """

    def __init__(self, sim: "ChipSimulator", shard: bool = True):
        if sim.lif.reset_mode != "hard":
            raise ValueError(
                "FusedEngine supports hard reset only (the chip's updater); "
                f"got reset_mode={sim.lif.reset_mode!r} — use "
                "engine='compiled'")
        super().__init__(sim, shard=shard)
        self.fused_weights = lower_fused_weights(sim)

    @property
    def codebook_layers(self) -> int:
        return sum(lw.codebook_mode for lw in self.fused_weights)

    def hbm_bytes_per_step(self, batch: int) -> int:
        """Weight + spike HBM bytes per timestep (the fused operands)."""
        return sum(lw.hbm_bytes_per_step(batch) for lw in self.fused_weights)

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
