"""SoC-level model (paper C5 + Fig. 7) of the port: 20 neuromorphic cores +
fullerene NoC + RISC-V control plane, with network->core mapping, the
array engines and full energy/cycle accounting.

Port of `repro.core.soc`.  The mapping, register-table and report code is
numpy, copied from the reference; weights and engine state are torch
tensors on the simulator's device.  The port has the three array engines
(`engine="compiled"`, `engine="fused"` and `engine="sharded"`, the last
over the ranks of a `torch.distributed` process group) and the
interpretive `engine="reference"`, with faults (`repro_torch.faults`),
tracing (`repro_torch.telemetry`) and on-chip plasticity
(`repro_torch.core.plasticity`).  The serving tier's host model (`register_table_bytes`, `HostDmaModel`),
`remap_mapping_cores` and the ENU control program are copies.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import energy as E
from repro_torch.core import noc as NOC
from repro_torch.core.quant import CodebookConfig
from repro_torch.core.zspe import CoreGeometry, CycleModel
from repro_torch.device import resolve_device
from repro_torch.faults import model as FM
from repro_torch.telemetry.trace import ChipTrace, TraceConfig, build_trace


@dataclasses.dataclass(frozen=True)
class RegisterTable:
    """Per-core configuration registers (Fig. 1).

    `codebook_words` holds the core's shared weight table exactly as the
    chip stores it: N signed W-bit integers; `codebook_scale` is the
    fixed-point step.  `codebook()` reconstructs the float table the SPEs
    dequantize against.
    """

    core_id: int
    enabled: bool = True
    threshold: float = 1.0
    leak: float = 0.9
    reset: float = 0.0
    weight_levels: int = 16       # N in {4,8,16}
    weight_bits: int = 8          # W in {4,8,16}
    codebook_words: tuple = ()    # N signed W-bit ints ((), if unprogrammed)
    codebook_scale: float = 1.0

    def __post_init__(self):
        if self.codebook_words:
            if len(self.codebook_words) != self.weight_levels:
                raise ValueError(
                    f"core {self.core_id}: {len(self.codebook_words)} codebook "
                    f"words for N={self.weight_levels}")
            lim = 2 ** (self.weight_bits - 1)
            bad = [w for w in self.codebook_words
                   if not (-lim <= int(w) <= lim - 1)]
            if bad:
                raise ValueError(
                    f"core {self.core_id}: codebook words {bad} exceed signed "
                    f"{self.weight_bits}-bit range")

    def codebook(self) -> np.ndarray:
        """The (N,) f32 weight table the SPEs read (words * scale)."""
        return (np.asarray(self.codebook_words, np.float32)
                * np.float32(self.codebook_scale))


def register_table_bytes(table: RegisterTable) -> int:
    """Configuration payload the host DMAs to program one core.

    Codebook: N words of W bits each (packed).  Neuron registers:
    threshold/leak/reset plus the codebook scale, one 32-bit word each,
    plus one 32-bit control word (enable bit, N/W fields, core id) — the
    Fig. 1 register file as the host interface sees it.
    """
    codebook_bits = table.weight_levels * table.weight_bits
    neuron_regs_bytes = 4 * 4          # threshold, leak, reset, scale
    control_bytes = 4
    return (codebook_bits + 7) // 8 + neuron_regs_bytes + control_bytes


@dataclasses.dataclass(frozen=True)
class HostDmaModel:
    """Host↔chip DMA interface model (SpikeHard-style packetized DMA).

    SpikeHard's host stack moves spikes and configuration over a
    descriptor-driven AXI DMA: the driver sets up a transfer (descriptor
    write + doorbell), then the engine streams fixed-size word bursts,
    each burst carrying a small packet header.  We keep that shape —
    per-transfer setup cost plus per-word streaming cost with packet
    header overhead — and price it in the chip's units (pJ, cycles at
    `freq_hz` of the consumer).  The per-word energy is an off-chip-I/O
    estimate in the same spirit as `energy.LEVEL2_HOP_PJ` (an off-die
    word movement costs roughly an order of magnitude more than on-die),
    not a paper anchor.

    Three transfer kinds the serve tier prices:

    * **spike upload** — the input event train, bitpacked 16 spikes per
      chip word exactly as the NoC/fused engine carry them
      (`core.zspe.pack_spike_words`), two chip words per 32-bit DMA word;
    * **table load** — reconfiguration: the register tables of a model
      being made resident (`register_table_bytes` each) — the
      NPARAM.INIT path, and the runtime model-swap cost of multi-tenant
      serving;
    * **output read** — the OBUF.READ path, one 32-bit count per output
      neuron.
    """

    word_bits: int = 32            # DMA/AXI word
    words_per_packet: int = 64     # burst length between headers
    header_words: int = 1          # per-packet header (dst/len/kind)
    setup_cycles: float = 120.0    # descriptor write + doorbell, per transfer
    cycles_per_word: float = 1.0   # streaming rate, words per chip cycle
    pj_per_word: float = 3.2       # off-chip word movement (estimate)

    def packets(self, n_words: int) -> int:
        return -(-int(n_words) // self.words_per_packet) if n_words else 0

    def transfer(self, n_words: int) -> tuple[float, float]:
        """(energy_pj, cycles) for one packetized transfer of n_words."""
        n_words = int(n_words)
        if n_words <= 0:
            return 0.0, 0.0
        total = n_words + self.packets(n_words) * self.header_words
        return (total * self.pj_per_word,
                self.setup_cycles + total * self.cycles_per_word)

    def spike_upload(self, timesteps: int, n_in: int) -> tuple[float, float]:
        """Upload one (T, n_in) binary event train, bitpacked 16
        spikes/chip-word (the chip's native spike-word layout)."""
        chip_words_per_step = -(-int(n_in) // 16)
        dma_words_per_step = -(-chip_words_per_step
                               // (self.word_bits // 16))
        return self.transfer(int(timesteps) * dma_words_per_step)

    def table_load(self, tables: Sequence[RegisterTable]
                   ) -> tuple[float, float]:
        """Reconfiguration DMA: stream every table's register payload."""
        n_bytes = sum(register_table_bytes(t) for t in tables)
        return self.transfer(-(-n_bytes // (self.word_bits // 8)))

    def output_read(self, n_out: int) -> tuple[float, float]:
        """Read back one 32-bit spike count per output neuron (OBUF)."""
        return self.transfer(int(n_out))


@dataclasses.dataclass(frozen=True)
class CoreAssignment:
    """A slice of one SNN layer placed on one physical core."""

    core_id: int                  # NoC node id (12..31)
    layer: int
    neuron_lo: int
    neuron_hi: int

    @property
    def n_neurons(self) -> int:
        return self.neuron_hi - self.neuron_lo


@dataclasses.dataclass
class Mapping:
    assignments: list[CoreAssignment]
    layer_sizes: list[int]

    def cores_of_layer(self, layer: int) -> list[CoreAssignment]:
        return [a for a in self.assignments if a.layer == layer]

    def active_core_ids(self) -> list[int]:
        return sorted({a.core_id for a in self.assignments})


def validate_capacity(layer_sizes: Sequence[int],
                      neurons_per_core: int = E.NEURONS_PER_CORE,
                      n_cores: int = NOC.N_CORES) -> None:
    """Reject networks that cannot fit the chip before any placement runs."""
    need = sum(int(s) for s in layer_sizes[1:])
    cap = n_cores * neurons_per_core
    if need > cap:
        raise ValueError(
            f"network needs {need} neurons but chip capacity is {cap} "
            f"({n_cores} cores x {neurons_per_core} neurons/core); "
            f"layer sizes {tuple(layer_sizes)} — use the compiler's "
            f"multi-domain scale-up (repro_torch.compiler.ChipSpec("
            f"max_domains=N)) for larger networks")


def map_network(layer_sizes: Sequence[int],
                neurons_per_core: int = E.NEURONS_PER_CORE,
                strategy: str = "greedy", seed: int = 0) -> Mapping:
    """Place a feed-forward SNN onto the 20 cores.

    strategy "greedy" is the legacy contiguous layout; any other value is
    forwarded to the mapping compiler (`repro_torch.compiler`), e.g.
    "anneal".  Layer 0 is the input population (not placed).  Raises
    ValueError when the network exceeds chip capacity.
    """
    validate_capacity(layer_sizes, neurons_per_core)
    if strategy != "greedy":
        from repro_torch import compiler as CC

        spec = CC.ChipSpec(neurons_per_core=neurons_per_core)
        compiled = CC.compile_network(list(layer_sizes), spec,
                                      strategy=strategy, seed=seed)
        return compiled.to_soc_mapping()
    cores = list(NOC.core_ids())
    assignments: list[CoreAssignment] = []
    nxt = 0
    for layer, size in enumerate(layer_sizes[1:], start=1):
        placed = 0
        while placed < size:
            if nxt >= len(cores):
                raise ValueError(
                    f"network needs more than {len(cores)} cores "
                    f"({layer_sizes})")
            take = min(neurons_per_core, size - placed)
            assignments.append(CoreAssignment(
                core_id=int(cores[nxt]), layer=layer,
                neuron_lo=placed, neuron_hi=placed + take))
            placed += take
            nxt += 1
    return Mapping(assignments=assignments, layer_sizes=list(layer_sizes))


def remap_mapping_cores(mapping: Mapping,
                        core_ids: Sequence[int]) -> Mapping:
    """Re-home a mapping onto an explicit set of physical cores.

    Used by multi-tenant packing: each tenant's network is compiled
    independently (so every mapping starts from the same low core ids),
    then remapped onto its disjoint slice of the chip.  The mapping's
    distinct cores (sorted) are assigned to `core_ids` (sorted)
    one-for-one, preserving every neuron slice; raises when the set is
    too small or contains non-core node ids.
    """
    used = sorted({a.core_id for a in mapping.assignments})
    pool = sorted(int(c) for c in core_ids)
    if len(pool) < len(used):
        raise ValueError(
            f"mapping uses {len(used)} cores but only {len(pool)} "
            f"physical cores were offered")
    valid = set(int(c) for c in NOC.core_ids())
    bad = [c for c in pool if c not in valid]
    if bad:
        raise ValueError(f"not chip core ids: {bad} (cores are "
                         f"{min(valid)}..{max(valid)})")
    table = dict(zip(used, pool))
    return Mapping(
        assignments=[dataclasses.replace(a, core_id=table[a.core_id])
                     for a in mapping.assignments],
        layer_sizes=list(mapping.layer_sizes))


def build_register_tables(mapping: Mapping, qweights=None, lif=None,
                          layer_cfgs=None,
                          default_cfg: CodebookConfig | None = None
                          ) -> list[RegisterTable]:
    """Lower a mapping (+ optional per-layer QuantizedTensors) to one
    programmed RegisterTable per core assignment.

    `layer_cfgs` supplies each placed layer's CodebookConfig; when absent
    it is inferred from the tensor (minimal W holding the words).  With no
    `qweights` the tables carry only the neuron registers.
    """
    from repro_torch.core import quant as Q
    from repro_torch.core.neuron import LIFParams

    lif = lif or LIFParams()
    default_cfg = default_cfg or CodebookConfig()
    tables = []
    for a in mapping.assignments:
        words: tuple = ()
        scale = 1.0
        cfg = default_cfg
        if qweights is not None:
            q = qweights[a.layer - 1]
            cfg = (layer_cfgs[a.layer - 1] if layer_cfgs is not None else
                   CodebookConfig(n_levels=int(q.codebook.shape[-1]),
                                  bit_width=Q.infer_bit_width(q)))
            words, scale = Q.register_entry_for_slice(
                q, cfg, a.neuron_lo, a.neuron_hi)
        tables.append(RegisterTable(
            core_id=a.core_id, threshold=lif.threshold, leak=lif.leak,
            reset=lif.reset, weight_levels=cfg.n_levels,
            weight_bits=cfg.bit_width, codebook_words=words,
            codebook_scale=scale))
    return tables


def _reject_index_like(w, layer: int, quant_cfg: CodebookConfig | None) -> None:
    """Catch codebook *indices* passed where weights belong.

    Integer arrays are always rejected.  In the codebook path (a quant_cfg
    is supplied) a float array whose values are all small non-negative
    integers below N is almost certainly `QuantizedTensor.idx` cast to
    float — raise instead of silently re-fitting k-means over indices.
    Binary {0, 1} matrices are exempt (max >= 2): k-means reproduces them.
    """
    if isinstance(w, torch.Tensor):
        integer = not (w.is_floating_point() or w.dtype == torch.bool)
    elif hasattr(w, "dtype"):
        integer = np.issubdtype(np.dtype(w.dtype), np.integer)
    else:
        raise TypeError(f"layer {layer}: expected a weight matrix, got {w!r}")
    if integer:
        raise TypeError(
            f"layer {layer}: integer weight array ({w.dtype}) looks like "
            f"codebook indices, not synaptic weights — pass the full "
            f"quant.QuantizedTensor (idx + codebook + scale) instead")
    if quant_cfg is not None:
        vals = np.asarray(torch.as_tensor(w).detach().cpu(), np.float32)
        if (vals.size and np.all(vals == np.round(vals)) and vals.min() >= 0
                and 2 <= vals.max() <= quant_cfg.n_levels - 1):
            raise ValueError(
                f"layer {layer}: float weight array holds only integers in "
                f"[0, {quant_cfg.n_levels}) — these look like codebook "
                f"indices; re-fitting a codebook over index values would "
                f"silently corrupt the network. Pass the QuantizedTensor "
                f"from quant.quantize(), or the dequantized float weights")


@dataclasses.dataclass
class StepStats:
    """Per-run accounting gathered by the engines."""

    nominal_sops: float = 0.0
    performed_sops: float = 0.0
    spikes_in: float = 0.0
    spikes_routed: float = 0.0
    neurons_touched: float = 0.0
    core_cycles: float = 0.0         # max over cores (parallel execution)
    noc_hops: float = 0.0
    noc_energy_pj: float = 0.0
    noc_contention_cycles: float = 0.0  # M/M/1 bottleneck-router wait cycles
    spike_words_skipped: float = 0.0  # ZSPE word-scan skips (fused engine)
    weight_writes: float = 0.0       # plasticity register-index writes

    @property
    def sparsity(self) -> float:
        if self.nominal_sops == 0:
            return 1.0
        return 1.0 - self.performed_sops / self.nominal_sops


@dataclasses.dataclass
class ChipReport:
    steps: int
    stats: StepStats                 # accumulated
    energy_pj: float
    core_energy_pj: float
    noc_energy_pj: float
    riscv_energy_pj: float
    wall_cycles: float
    freq_hz: float
    write_energy_pj: float = 0.0     # plasticity weight-write energy

    @property
    def pj_per_sop(self) -> float:
        return self.energy_pj / max(self.stats.nominal_sops, 1.0)

    @property
    def power_mw(self) -> float:
        t_s = self.wall_cycles / self.freq_hz
        return self.energy_pj * 1e-12 / max(t_s, 1e-12) * 1e3

    @property
    def gsops(self) -> float:
        t_s = self.wall_cycles / self.freq_hz
        return self.stats.nominal_sops / max(t_s, 1e-12) / 1e9


class ChipSimulator:
    """Functional + energy simulation of the whole SoC for a feed-forward
    SNN described by per-layer weight matrices, on a torch device.

    * ``engine="compiled"`` (default) — `engine.CompiledEngine`: per
      layer-step a dense `spikes @ w` against dequantized f32 weights plus
      `lif_step`, batched over B, a Python loop over T.
    * ``engine="fused"`` — `engine.FusedEngine`: each layer-step is one
      fused-timestep kernel (kernels/fused_timestep.py) on bitpacked uint16
      spike words with codebook-compressed weights.  This is the main path.
    * ``engine="sharded"`` — `engine.ShardedEngine`: a multi-domain board
      split by domains over the ranks of the default `torch.distributed`
      process group (one process per card, e.g. under ``torchrun
      --nproc-per-node=N``, or gloo ranks on the CPU), the shards
      exchanging packed spike words after every layer-step; with no
      group, one process runs the whole board as one shard.  Every rank
      builds the same simulator and calls the same `run_batch`.
    * ``engine="reference"`` — the interpretive loop (one sample, one
      timestep, one layer at a time, counters crossing to the host each
      layer-step): the port's own semantic oracle, launching no kernel.

    ``faults`` (a `faults.FaultConfig`) folds a faulty chip into the
    weights, register tables and a seeded drop plan at construction;
    ``trace`` (a `telemetry.TraceConfig`) makes each run leave a
    `ChipTrace` in `last_trace()`; ``plasticity`` (a
    `plasticity.PlasticityConfig`) makes the chosen layers learn their
    codebook indexes during a run (`last_learned`, `apply_reward`, and
    `run_batch(learned=)` to warm-start).  `device` defaults to the card
    (`repro_torch.resolve_device`); pass ``device="cpu"`` to run the plain
    versions on the CPU.
    """

    def __init__(
        self,
        weights: Sequence,                     # [(n_pre, n_post) arrays] or
                                               # [quant.QuantizedTensor, ...]
        quant_cfg: CodebookConfig | None = None,
        freq_hz: float = 100e6,
        geometry: CoreGeometry | None = None,
        zero_skip: bool = True,
        partial_update: bool = True,
        leak: float = 0.9,
        threshold: float = 1.0,
        mapping: Mapping | None = None,
        mapping_strategy: str = "anneal",
        engine: str = "compiled",
        register_tables: Sequence[RegisterTable] | None = None,
        lif=None,
        trace=None,
        faults=None,
        plasticity=None,
        device=None,
    ):
        from repro_torch.core import quant as Q
        from repro_torch.core.neuron import LIFParams
        from repro_torch.core.plasticity import NULL_PLASTICITY

        if engine not in ("compiled", "fused", "sharded", "reference"):
            raise ValueError(f"engine must be 'compiled', 'fused', "
                             f"'sharded' or 'reference', got {engine!r}")
        self.device = resolve_device(device)
        weights = list(weights)
        n_quant = sum(isinstance(w, Q.QuantizedTensor) for w in weights)
        if 0 < n_quant < len(weights):
            raise TypeError(
                "weights mix QuantizedTensor and raw arrays — quantize every "
                "layer (or none) before building the simulator")
        self.qweights: list | None = None
        self._layer_qcfg: list | None = None
        if n_quant:
            # already-fitted codebooks: the chip runs the register-word
            # round trip of each table, never a re-fit; N/W are per-core
            # register fields, validated per layer against quant_cfg
            self._layer_qcfg = []
            for li, q in enumerate(weights):
                n = int(q.codebook.shape[-1])
                wb = Q.infer_bit_width(q)
                if quant_cfg is not None:
                    if n != quant_cfg.n_levels:
                        raise ValueError(
                            f"layer {li}: codebook has {n} levels but "
                            f"quant_cfg says N={quant_cfg.n_levels}")
                    if wb > quant_cfg.bit_width:
                        raise ValueError(
                            f"layer {li}: codebook words need W={wb} bits "
                            f"but quant_cfg says W={quant_cfg.bit_width}")
                    wb = quant_cfg.bit_width
                self._layer_qcfg.append(
                    CodebookConfig(n_levels=n, bit_width=wb))
            quant_cfg = quant_cfg or self._layer_qcfg[0]
            self.qweights = [Q.QuantizedTensor(
                idx=q.idx.to(self.device), codebook=q.codebook.to(self.device),
                scale=q.scale.to(self.device),
                group_axis_size=q.group_axis_size) for q in weights]
            self.weights = [Q.dequantize_via_registers(q, c.bit_width)
                            for q, c in zip(self.qweights, self._layer_qcfg)]
        else:
            for li, w in enumerate(weights):
                _reject_index_like(w, li, quant_cfg)
            self.weights = [self._as_weight(w) for w in weights]
        sizes = ([int(self.weights[0].shape[0])]
                 + [int(w.shape[1]) for w in self.weights])
        self.mapping = mapping or map_network(sizes, strategy=mapping_strategy)
        self.quant_cfg = quant_cfg or CodebookConfig(n_levels=16, bit_width=8)
        self.geom = geometry or CoreGeometry(freq_hz=freq_hz)
        self.freq_hz = freq_hz
        self.zero_skip = zero_skip
        self.partial_update = partial_update
        self.faults = faults if faults is not None else FM.NULL_FAULTS
        self.cycle_model = CycleModel(self.geom)
        self.core_model = E.calibrate_core()
        self.riscv = E.RiscvPowerModel()
        self.router = NOC.RouterParams()
        self.write_model = E.WeightWriteModel()
        # a mapping with core ids beyond one domain (from the compiler's
        # scale-up stage) runs on the matching multi-domain fabric, with
        # level-2 hops priced at the off-chip rate
        max_node = max(a.core_id for a in self.mapping.assignments)
        if max_node >= NOC.N_NODES:
            n_domains = max_node // NOC.DOMAIN_STRIDE + 1
            self.adj = NOC.multi_domain_adjacency(n_domains)
            self._level2 = frozenset(
                int(x) for x in NOC.level2_node_ids(n_domains))
            self.interconnect = E.InterconnectEnergyModel.from_router(
                self.router)
        else:
            self.adj = NOC.fullerene_adjacency()
            self._level2 = frozenset()
            self.interconnect = None
        if self.faults.rerouted and self.faults.topology_faults():
            # repaired chip: CMRouter tables are reprogrammed on the
            # surviving graph, so routes below detour around the faults
            # (and the replay prices the detours); unreachable pairs fail
            # loudly in _compile_layer_routes
            self.adj = FM.masked_adjacency(self.adj, self.faults)
        self.routing = NOC.RoutingTable(self.adj)
        # routes are compiled ONCE from the mapping; each timestep only
        # replays them (no BFS in the simulation loop)
        self._layer_routes = self._compile_layer_routes()
        # a full LIFParams wins over the scalar threshold/leak conveniences
        self.lif = (dataclasses.replace(lif, partial_update=partial_update)
                    if lif is not None else
                    LIFParams(threshold=threshold, leak=leak,
                              partial_update=partial_update))
        if quant_cfg is not None and self.qweights is None:
            # float weights + a codebook config = post-training fit here
            self.qweights = [Q.quantize(w, quant_cfg) for w in self.weights]
            self._layer_qcfg = [quant_cfg] * len(self.weights)
            self.weights = [Q.dequantize_via_registers(q, quant_cfg.bit_width)
                            for q in self.qweights]
        self.register_tables = (list(register_tables)
                                if register_tables is not None
                                else self._build_register_tables())
        # static faults fold into the weights/tables HERE — before the
        # touch masks, so both engines inherit them with no lowering
        # changes; a null config returns without touching anything
        FM.apply_chip_faults(self)
        self.drop_plan = FM.build_drop_plan(self)
        self._dispatch_count = 0
        # connectivity masks for the partial-update touch set (see
        # neuron.touch_mask): computed AFTER quantization so both engines
        # see the synapses the chip actually programs
        self.nonzero_weights = [(w != 0).to(torch.float32)
                                for w in self.weights]
        self.engine = engine
        # opt-in per-timestep capture (repro_torch.telemetry): trace-off
        # runs issue no extra ops
        self.trace = trace or TraceConfig()
        # opt-in on-chip learning (core/plasticity.py): disabled, runs
        # issue exactly the inference ops
        self.plasticity = (plasticity if plasticity is not None
                           else NULL_PLASTICITY)
        self._plast_tables = None  # lazy lower_plasticity_tables result
        self._ref_learned = None   # reference-engine learned indexes
        self._ref_elig = None      # reference-engine eligibility traces
        self._last_trace = None    # reference-engine ChipTrace
        self._compiled = None      # CompiledEngine, built lazily
        self._fused = None         # FusedEngine, built lazily
        self._sharded = None       # ShardedEngine, built lazily

    def _as_weight(self, w) -> torch.Tensor:
        if isinstance(w, torch.Tensor):
            return w.detach().to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(w, np.float32), device=self.device)

    def compiled_engine(self):
        """The lazily-built dense array engine for this mapping."""
        if self._compiled is None:
            from repro_torch.core.engine import CompiledEngine
            with torch.profiler.record_function("soc.lower"):
                self._compiled = CompiledEngine(self)
        return self._compiled

    def fused_engine(self):
        """The lazily-built fused-kernel engine for this mapping."""
        if self._fused is None:
            from repro_torch.core.engine import FusedEngine
            with torch.profiler.record_function("soc.lower"):
                self._fused = FusedEngine(self)
        return self._fused

    def sharded_engine(self, n_shards: int | None = None):
        """The lazily-built cores-axis engine for this mapping.

        ``n_shards`` (first call only) overrides the default split of the
        mapping's domains over the process group's ranks."""
        if self._sharded is None:
            from repro_torch.core.engine import ShardedEngine
            with torch.profiler.record_function("soc.lower"):
                self._sharded = ShardedEngine(self, n_shards=n_shards)
        return self._sharded

    def array_engine(self):
        """The array engine selected at construction (compiled, fused or
        sharded); raises for the reference engine, which has no
        lowering."""
        if self.engine == "fused":
            return self.fused_engine()
        if self.engine == "sharded":
            return self.sharded_engine()
        if self.engine == "compiled":
            return self.compiled_engine()
        raise ValueError("the reference engine is interpretive — no "
                         "array lowering to return")

    def _built_engine(self):
        """The selected array engine if it was built, else None."""
        return {"fused": self._fused, "sharded": self._sharded,
                "compiled": self._compiled}[self.engine]

    def last_trace(self):
        """The ChipTrace captured by the most recent run (None when the
        simulator was built without `trace=TraceConfig(enabled=True)` or
        has not run yet).  Schema-identical across the four engines."""
        if self.engine == "reference":
            return self._last_trace
        eng = self._built_engine()
        return eng.last_trace if eng is not None else None

    def plasticity_tables(self):
        """Per-layer plasticity lowering: None for frozen layers, else the
        (idx0 int8, cbw f32 inf-padded) pair every engine learns over —
        one lowering, so initial state cannot drift."""
        if self._plast_tables is None:
            from repro_torch.core.engine import lower_plasticity_tables
            self._plast_tables = lower_plasticity_tables(self)
        return self._plast_tables

    @property
    def last_learned(self):
        """Per-layer learned codebook indexes from the most recent
        plasticity-enabled run (None entries for frozen layers; batch axis
        leading for batched runs)."""
        if self.engine == "reference":
            return self._ref_learned
        eng = self._built_engine()
        return eng.last_learned if eng is not None else None

    def apply_reward(self, reward):
        """Reward-mode trial commit: turn the eligibility accumulated by
        the last run into priced register writes (see
        plasticity.commit_reward).  Returns the write-accounting dict."""
        if self.engine != "reference":
            return self.array_engine().apply_reward(reward)
        from repro_torch.core import plasticity as PLC
        if self.plasticity.mode != "reward" or self._ref_elig is None:
            raise ValueError("apply_reward needs a completed reward-mode "
                             "run to commit")
        self._ref_learned, info = PLC.commit_reward(
            self.plasticity, self.plasticity_tables(), self._ref_learned,
            self._ref_elig, reward, self.write_model, self.cycle_model)
        self._ref_elig = None
        return info

    def _build_register_tables(self) -> list[RegisterTable]:
        """One programmed RegisterTable per core assignment: with quantized
        weights the core's shared table is the layer codebook (the group
        covering the core's slice), lowered to W-bit words."""
        return build_register_tables(
            self.mapping, qweights=self.qweights, lif=self.lif,
            layer_cfgs=self._layer_qcfg, default_cfg=self.quant_cfg)

    def _compile_layer_routes(self) -> dict[int, list[NOC.FlowRoute]]:
        """Static routes for every layer->layer transition in the mapping:
        the spikes layer `li` fires travel from each of its cores to every
        core holding layer `li+1`."""
        routes: dict[int, list[NOC.FlowRoute]] = {}
        for li in range(1, len(self.weights)):
            srcs = [a.core_id for a in self.mapping.cores_of_layer(li)]
            dsts = sorted({a.core_id
                           for a in self.mapping.cores_of_layer(li + 1)})
            routes[li] = [NOC.compile_flow(self.routing, s, dsts, self._level2)
                          for s in srcs]
        return routes

    # -- execution ----------------------------------------------------------

    def _consume_transient_fault(self) -> None:
        """Raise `TransientChipFault` when this dispatch index is listed in
        `faults.transient_dispatches`.  Engines call it after the run but
        before results are read back — a mid-flight loss, so a retry
        (same FaultConfig, next dispatch index) can succeed."""
        i = self._dispatch_count
        self._dispatch_count += 1
        if i in self.faults.transient_dispatches:
            raise FM.TransientChipFault(
                f"injected transient fault at dispatch {i}")

    def run(self, spike_train, learned=None
            ) -> tuple[torch.Tensor, ChipReport]:
        """spike_train: (T, n_in) binary -> (out_spike_counts, report).

        `learned` (plasticity only) warm-starts the learnable layers'
        codebook indexes, e.g. with a previous run's `last_learned`.
        """
        if self.engine != "reference":
            return self.array_engine().run(spike_train, learned=learned)
        return self.run_reference(spike_train, learned=learned)

    def run_batch(self, spike_trains, learned=None
                  ) -> tuple[torch.Tensor, list[ChipReport]]:
        """spike_trains: (B, T, n_in) -> ((B, n_out) counts, one ChipReport
        per sample).  The array engines run the batch as one pass; the
        reference engine loops samples.

        With plasticity enabled every sample starts from the same initial
        indexes (broadcast `learned`, or per-sample (B, ...) entries) and
        `last_learned` holds per-sample finals — learning is not chained
        across the batch.
        """
        if self.engine != "reference":
            return self.array_engine().run_batch(spike_trains,
                                                 learned=learned)
        outs, reports, traces, finals, eligs = [], [], [], [], []
        trains = torch.as_tensor(spike_trains)
        for b in range(int(trains.shape[0])):
            lb = None
            if learned is not None:
                lb = [None if l is None else (l[b] if np.ndim(l) == 3 else l)
                      for l in learned]
            counts, rep = self.run_reference(trains[b], learned=lb)
            outs.append(counts)
            reports.append(rep)
            if self._ref_learned is not None:
                finals.append(self._ref_learned)
                eligs.append(self._ref_elig)
            if self._last_trace is not None:
                traces.append(self._last_trace)
        self._consume_transient_fault()
        if traces:
            self._last_trace = ChipTrace.concat(traces)
        if finals:
            self._ref_learned = [
                None if finals[0][li] is None
                else torch.stack([f[li] for f in finals])
                for li in range(len(finals[0]))]
            self._ref_elig = (None if eligs[0] is None else [
                None if eligs[0][li] is None
                else torch.stack([e[li] for e in eligs])
                for li in range(len(eligs[0]))])
        return torch.stack(outs), reports

    def run_reference(self, spike_train, learned=None
                      ) -> tuple[torch.Tensor, ChipReport]:
        """The interpretive per-timestep loop, the port's semantic oracle:
        one sample, one timestep, one layer at a time on the simulator's
        device, each layer-step's spikes crossing to the host for the
        scalar cycle model and the NoC replay.  Tensors keep a batch axis
        of one, so a layer-step issues the compiled engine's ops for a
        batch of one, and a learnable layer runs `engine.PlasticRun`."""
        from repro_torch.core import plasticity as PLC
        from repro_torch.core import zspe as Z
        from repro_torch.core.engine import PlasticRun
        from repro_torch.core.neuron import init_state, lif_step, touch_mask

        plast = self.plasticity
        if learned is not None and not plast.enabled:
            raise ValueError("learned indexes passed but plasticity is off")
        dev = self.device
        learn = None
        if plast.enabled:
            idx0 = [None if pt is None else PLC.as_indexes(
                        pt[0] if learned is None or learned[li] is None
                        else learned[li], dev)[None]
                    for li, pt in enumerate(self.plasticity_tables())]
            learn = PlasticRun(self, idx0,
                               [int(w.shape[0]) for w in self.weights])

        train = torch.as_tensor(spike_train).to(dev, torch.float32)
        T = int(train.shape[0])
        states = [init_state(int(w.shape[1]), (1,), dev)
                  for w in self.weights]
        out_counts = torch.zeros((1, int(self.weights[-1].shape[1])),
                                 device=dev)
        acc = StepStats()
        wall = 0.0
        traced = self.trace.enabled
        trace_skips = traced and self.trace.skip_words
        # raw trace counters (the four tensors the array engines emit);
        # every derived series comes from telemetry.build_trace
        rec_fired: list[list[float]] = []
        rec_touched: list[list[float]] = []
        rec_nnz: list[list[float]] = []
        rec_skip: list[list[float]] = []
        rec_writes: list[list[float]] = []

        for t in range(T):
            spikes = train[t][None]                            # (1, n_in)
            per_core_cycles: dict[int, float] = {}
            step_load = np.zeros(self.adj.shape[0], np.float64)
            if traced:
                for rec in (rec_fired, rec_touched, rec_nnz, rec_skip,
                            rec_writes):
                    rec.append([])
            for li, w in enumerate(self.weights):
                n_pre, n_post = int(w.shape[0]), int(w.shape[1])
                nnz = float((spikes != 0).sum())
                acc.spikes_in += nnz
                if traced:
                    rec_nnz[-1].append(nnz)
                    if trace_skips:
                        rec_skip[-1].append(float(Z.empty_spike_words(
                            Z.pack_spike_words(spikes))[0]))
                col_ch = None
                if learn is not None and learn.learns(li):
                    # live weights from the carried indexes, through the
                    # layer-step the array engines run
                    states[li], out, touched, col_w = learn.step(
                        li, spikes, states[li], self.lif)
                    if col_w is not None:
                        col_ch = col_w[0].cpu().numpy().astype(np.float64)
                        acc.weight_writes += float(col_ch.sum())
                else:
                    states[li], out, touched = lif_step(
                        states[li], spikes @ w, self.lif,
                        touched=touch_mask(spikes, self.nonzero_weights[li]))
                touched_np = touched[0].cpu().numpy()
                out_np = out[0].cpu().numpy()
                acc.nominal_sops += n_pre * n_post
                acc.performed_sops += nnz * n_post
                acc.neurons_touched += float(touched_np.sum())
                if traced:
                    rec_writes[-1].append(
                        float(col_ch.sum()) if col_ch is not None else 0.0)
                asn = self.mapping.cores_of_layer(li + 1)
                # cycles for each core holding a slice of this layer, from
                # the exact (integer) touched count of the core's slice
                for a in asn:
                    core_touched = float(
                        touched_np[a.neuron_lo:a.neuron_hi].sum())
                    cyc = self.cycle_model.timestep_cycles(
                        n_pre, a.n_neurons, nnz, core_touched,
                        self.zero_skip, self.partial_update,
                        writes=(float(
                            col_ch[a.neuron_lo:a.neuron_hi].sum())
                            if col_ch is not None else None))
                    per_core_cycles[a.core_id] = (
                        per_core_cycles.get(a.core_id, 0.0) + cyc)
                    if traced:
                        rec_touched[-1].append(core_touched)
                        rec_fired[-1].append(
                            float(out_np[a.neuron_lo:a.neuron_hi].sum()))
                # NoC: the spikes each source core fired travel its own
                # precompiled flow (replay, no BFS here) — source-exact
                fired = float(out_np.sum())
                if fired > 0 and li + 1 < len(self.weights):
                    routes = self._layer_routes[li + 1]
                    fired_per_src = [
                        int(out_np[a.neuron_lo:a.neuron_hi].sum())
                        for a in asn]
                    rep = NOC.replay_flows(
                        list(zip(routes, fired_per_src)), self.router,
                        n_nodes=self.adj.shape[0],
                        interconnect=self.interconnect)
                    acc.noc_hops += rep.total_hops
                    acc.noc_energy_pj += rep.energy_pj
                    acc.spikes_routed += fired
                    step_load += rep.router_load
                # per-hop packet drop (faults.DropPlan): fired counters
                # above are pre-drop (the source committed the energy);
                # what the next layer integrates is post-drop
                if (self.drop_plan is not None
                        and self.drop_plan.keep_p[li] is not None):
                    spikes = out * self.drop_plan.mask(li, t, dev)
                else:
                    spikes = out
            out_counts = out_counts + spikes
            core_wall = (max(per_core_cycles.values()) if per_core_cycles
                         else 1.0)
            # bottleneck-router contention stalls the timestep barrier
            cont = float(NOC.contention_cycles(
                step_load.max(), core_wall, self.router))
            acc.noc_contention_cycles += cont
            wall += core_wall + cont

        if learn is not None:
            finals = learn.finals()
            self._ref_learned = [
                finals[f"learned_idx_{li}"][0] if learn.learns(li) else None
                for li in range(len(self.weights))]
            self._ref_elig = ([
                finals[f"elig_{li}"][0] if learn.learns(li) else None
                for li in range(len(self.weights))]
                if plast.mode == "reward" else None)
        if traced:
            self._last_trace = build_trace(
                self,
                np.asarray(rec_fired, np.float64)[None],      # (1, T, S)
                np.asarray(rec_touched, np.float64)[None],
                np.asarray(rec_nnz, np.float64)[None],
                (np.asarray(rec_skip, np.float64)[None]
                 if trace_skips else None),
                weight_writes=(np.asarray(rec_writes, np.float64)[None]
                               if plast.enabled else None))
        return out_counts[0], self._report(T, acc, wall)

    def _report(self, steps: int, acc: StepStats, wall: float) -> ChipReport:
        # one pricing implementation for every engine (energy.price_batched;
        # the array engines call it with batch arrays)
        priced = E.price_batched(
            self.core_model, self.riscv,
            nominal_sops=acc.nominal_sops, performed_sops=acc.performed_sops,
            noc_energy_pj=acc.noc_energy_pj, wall_cycles=wall, steps=steps,
            freq_hz=self.freq_hz, zero_skip=self.zero_skip,
            partial_update=self.partial_update,
            weight_writes=acc.weight_writes, write_model=self.write_model)
        return ChipReport(
            steps=steps, stats=acc,
            energy_pj=float(priced["total_pj"]),
            core_energy_pj=float(priced["core_pj"]),
            noc_energy_pj=acc.noc_energy_pj,
            riscv_energy_pj=float(priced["riscv_pj"]),
            wall_cycles=wall, freq_hz=self.freq_hz,
            write_energy_pj=float(priced["write_pj"]))



# ---------------------------------------------------------------------------
# ENU — extended neuromorphic instruction set (paper C5)
# ---------------------------------------------------------------------------

ENU_OPCODES = {
    "NPARAM.INIT": 0x0,   # network parameter initialization (DMA descriptors)
    "CORE.EN": 0x1,       # core enable mask -> register tables / clock gates
    "NET.START": 0x2,     # network startup (timestep engine go)
    "NET.WAIT": 0x3,      # sleep until network-computing-finish IRQ
    "TS.SYNC": 0x4,       # timestep-switch barrier
    "OBUF.READ": 0x5,     # read one of the 4 x 0.2 KB output buffers
}


@dataclasses.dataclass
class EnuInstruction:
    op: str
    arg: int = 0

    def encode(self) -> int:
        return (ENU_OPCODES[self.op] << 28) | (self.arg & 0x0FFFFFFF)


class EnuProgram:
    """A control program for one inference — used by the SoC timeline model
    to derive the RISC-V duty cycle (Fig. 6) instead of assuming it."""

    def __init__(self, instrs: list[EnuInstruction]):
        self.instrs = instrs

    @staticmethod
    def standard_inference(core_mask: int, timesteps: int) -> "EnuProgram":
        body = [EnuInstruction("NPARAM.INIT"), EnuInstruction("CORE.EN", core_mask),
                EnuInstruction("NET.START", timesteps)]
        body += [EnuInstruction("TS.SYNC", t) for t in range(timesteps)]
        body += [EnuInstruction("NET.WAIT"), EnuInstruction("OBUF.READ", 0)]
        return EnuProgram(body)

    def timeline(self, cycles_per_timestep: float,
                 cpu_cycles_per_instr: float = 40.0,
                 cpu_freq_hz: float = 16e6, net_freq_hz: float = 100e6
                 ) -> tuple[float, float]:
        """Returns (t_active_s, t_sleep_s) for the RISC-V core."""
        active_instr = [i for i in self.instrs if i.op not in ("NET.WAIT", "TS.SYNC")]
        t_active = len(active_instr) * cpu_cycles_per_instr / cpu_freq_hz
        n_wait = sum(1 for i in self.instrs if i.op in ("NET.WAIT", "TS.SYNC"))
        t_sleep = n_wait * cycles_per_timestep / net_freq_hz
        return t_active, t_sleep
