"""repro_torch.compiler — the network-to-chip mapping compiler.

Four stages behind one entry point:

    compile_network(net, chip) ->
        partition  (layers -> <= 8192-neuron, one-codebook core groups)
        place      (hop-weighted traffic optimization on the fullerene NoC)
        route      (static per-CMRouter connection-matrix tables)
        scale-up   (> 20-core networks span level-1 domains via level-2
                    routers, priced by energy.InterconnectEnergyModel)

`net` may be a NetworkGraph, a models/snn.py SNNConfig, a
models/snn_conv.py ConvSNNConfig, a list of weight matrices, or a plain
sequence of layer sizes.  The result's `.to_soc_mapping()` plugs straight
into core.soc.ChipSimulator, and `.routed.layer_flows` gives the
simulator precompiled routes so nothing BFS-searches at sim time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from repro_torch.compiler import ir, partition as P, place as PL, route as R
from repro_torch.compiler import scaleup as SU
from repro_torch.compiler.ir import (ChipSpec, LayerSpec, NetworkGraph,
                               estimate_spike_rates, from_conv_config,
                               from_layer_sizes, from_snn_config,
                               from_weights, measure_spike_rates)
from repro_torch.compiler.partition import (CoreGroup, DomainPlan, assign_domains,
                                      group_traffic)
from repro_torch.compiler.place import (DomainPlacement, Placement,
                                  derive_domain_seed)
from repro_torch.compiler.route import (RoutedNetwork, RouterTables,
                                  route_hierarchical, verify_roundtrip)
from repro_torch.compiler.scaleup import ScaleUpPlan

__all__ = [
    "ChipSpec", "CompiledNetwork", "CoreGroup", "DomainPlacement",
    "DomainPlan", "LayerSpec", "NetworkGraph",
    "Placement", "RoutedNetwork", "RouterTables", "ScaleUpPlan",
    "assign_domains", "compile_network", "derive_domain_seed",
    "estimate_spike_rates", "from_conv_config",
    "from_layer_sizes", "from_snn_config", "from_weights",
    "measure_spike_rates", "recompile", "repair", "route_hierarchical",
    "verify_roundtrip",
]


@dataclasses.dataclass
class CompiledNetwork:
    """Everything the chip needs to run the network, plus cost telemetry."""

    net: NetworkGraph
    spec: ChipSpec
    groups: list[CoreGroup]
    placement: Placement
    plan: ScaleUpPlan
    routed: RoutedNetwork
    baseline_cost: float          # contiguous-greedy placement, same metric
    # hierarchical-compile artifacts (None/empty on the flat path)
    domain_plan: DomainPlan | None = None
    domain_placements: dict[int, DomainPlacement] | None = None
    hierarchical: bool = False
    options: dict = dataclasses.field(default_factory=dict)
    recompile_stats: dict | None = None
    # the FaultConfig this network was compiled around (None = healthy
    # chip); a repaired compile carries faults.with_rerouted() so the
    # simulator masks its fabric to match the reprogrammed routes
    faults: Any = None

    @property
    def cost(self) -> float:
        return self.placement.cost

    @property
    def improvement(self) -> float:
        """baseline/optimized hop-weighted traffic cost (>1 == better)."""
        return self.baseline_cost / max(self.cost, 1e-12)

    @property
    def n_domains_used(self) -> int:
        return SU.domains_used(self.placement.assignment, self.plan)

    def core_of_group(self, gid: int) -> int:
        return self.placement.assignment[gid]

    def energy_summary(self) -> dict:
        return SU.domain_energy_summary(self.net, self.routed, self.spec)

    def to_soc_mapping(self):
        """Convert to the core.soc.Mapping the ChipSimulator consumes."""
        from repro_torch.core.soc import CoreAssignment, Mapping

        assignments = [
            CoreAssignment(core_id=self.placement.assignment[g.gid],
                           layer=g.layer, neuron_lo=g.lo, neuron_hi=g.hi)
            for g in self.groups
        ]
        return Mapping(assignments=assignments,
                       layer_sizes=list(self.net.layer_sizes()))

    def register_tables(self, qweights, lif=None) -> list:
        """Program one core.soc.RegisterTable per placed core group from
        fitted per-layer `quant.QuantizedTensor`s: each core's shared weight
        table is its layer codebook lowered to signed W-bit register words
        (bit-exact round trip — see quant.codebook_to_words).  `lif`
        optionally supplies the neuron register fields.  Delegates to
        soc.build_register_tables, the single lowering implementation."""
        from repro_torch.core import quant as Q
        from repro_torch.core.soc import build_register_tables

        if len(qweights) != len(self.net.placed_layers):
            raise ValueError(
                f"{len(qweights)} quantized tensors for "
                f"{len(self.net.placed_layers)} placed layers")
        for li, q in enumerate(qweights):
            if not isinstance(q, Q.QuantizedTensor):
                raise TypeError(
                    f"layer {li}: register tables need QuantizedTensor "
                    f"(got {type(q).__name__}) — run quant.quantize first")
        return build_register_tables(self.to_soc_mapping(),
                                     qweights=list(qweights), lif=lif)

    def summary(self) -> dict:
        es = self.energy_summary()
        return {
            "layers": len(self.net.placed_layers),
            "groups": len(self.groups),
            "domains": self.n_domains_used,
            "strategy": self.placement.strategy,
            "cost": round(self.cost, 3),
            "baseline_cost": round(self.baseline_cost, 3),
            "improvement": round(self.improvement, 3),
            "congestion": round(self.placement.congestion, 3),
            "router_table_entries": self.routed.router_tables.n_entries(),
            "l2_hops_per_step": round(es["l2_hops_per_step"], 3),
            "noc_pj_per_step": round(es["noc_pj_per_step"], 3),
        }


def _as_network(net: Any) -> NetworkGraph:
    if isinstance(net, NetworkGraph):
        return net
    # frontends, duck-typed so no model module is imported here
    if hasattr(net, "in_shape") and hasattr(net, "channels"):
        return from_conv_config(net)
    if hasattr(net, "layer_sizes"):
        return from_snn_config(net)
    if isinstance(net, Sequence) and len(net) and hasattr(net[0], "shape"):
        # raw weight matrices OR quant.QuantizedTensors (whose .shape is
        # the index-tensor shape) — both expose per-layer (n_pre, n_post)
        return from_weights(net)
    if isinstance(net, Sequence):
        return from_layer_sizes(net)
    raise TypeError(f"cannot interpret {type(net)!r} as a network")


def compile_network(net: Any, chip: ChipSpec | None = None, *,
                    strategy: str = "anneal", seed: int = 0,
                    anneal_iters: int = 4000, spread: bool = True,
                    congestion_weight: float = 0.0,
                    hierarchical: bool | None = None,
                    faults: Any = None,
                    _cache: dict | None = None,
                    _stats: dict | None = None,
                    verify: bool = False) -> CompiledNetwork:
    """Run the full partition -> place -> route -> scale-up pipeline.

    strategy: "anneal" (default), "greedy" (constructive only), or
    "contiguous" (the legacy layout, for baselines).  `spread` hands idle
    cores to big layers (lower wall cycles, more placement freedom).
    `congestion_weight > 0` adds the bottleneck CMRouter's spike occupancy
    (what the engines charge as `noc_contention_cycles`) to the anneal
    objective — trade hops for a flatter router-load profile; the
    resulting `Placement.congestion` records the bottleneck either way.

    `faults` (a faults.FaultConfig with topology faults) compiles around
    the failures: dead cores' slots are removed (their neuron slices
    remap onto spare capacity), placement distances and routes come from
    the fault-masked adjacency (BFS detours around failed routers/links),
    and the result carries the config in `.faults`.  Raises ValueError
    when the surviving graph cannot route a required flow.  Prefer
    `repair` to recompile an existing network around new faults — it
    reuses every unaffected domain's placement from the previous compile.

    `hierarchical` selects partition-then-place per level-1 domain: a
    chip/domain grouping pass fixes which domain every group lives in,
    each domain anneals independently on a shared 33-node local table
    (per-domain derived RNG seeds), and routes are composed from local
    paths plus the direct level-2 edge.  Default (None) auto-enables it
    for multi-domain anneal compiles; pass False to force the flat
    global-table path.  Same cost metric, same FlowRoutes — only the
    compile-time scaling changes.
    """
    spec = chip or ChipSpec()
    graph = _as_network(net)
    options = dict(strategy=strategy, seed=seed, anneal_iters=anneal_iters,
                   spread=spread, congestion_weight=congestion_weight,
                   hierarchical=hierarchical, faults=faults)

    groups = P.partition(graph, spec, spread=spread)
    flows = group_traffic(graph, groups)
    su = SU.plan(groups, spec)
    topo = faults is not None and faults.topology_faults()
    if topo:
        from repro_torch.faults.model import masked_adjacency

        adjacency = masked_adjacency(su.adjacency, faults)
        dead = frozenset(int(c) for c in faults.dead_cores)
        slot_set = {int(s) for s in np.asarray(su.core_slots)}
        if not dead <= slot_set:
            raise ValueError(f"dead cores {sorted(dead - slot_set)} are "
                             "not core slots of this chip")
    else:
        adjacency = su.adjacency
        dead = frozenset()
    hier = (su.multi_domain and strategy == "anneal"
            if hierarchical is None else bool(hierarchical))
    if hier and not su.multi_domain:
        hier = False                      # one domain: flat IS the local solve
    if hier and strategy != "anneal":
        raise ValueError(
            f"hierarchical compilation refines per-domain anneals; "
            f"strategy {strategy!r} has no hierarchical form")

    if hier:
        l2w = spec.interconnect.level2_premium()
        capacity = None
        if dead:
            from repro_torch.core import noc as NOC
            per_dom: dict[int, int] = {}
            for c in dead:
                d = int(c) // NOC.DOMAIN_STRIDE
                per_dom[d] = per_dom.get(d, 0) + 1
            capacity = {d: spec.n_cores - k for d, k in per_dom.items()}
        dplan = P.assign_domains(groups, flows, spec, su.n_domains,
                                 capacity=capacity)
        placement, dplacements = PL.place_hierarchical(
            groups, flows, dplan, spec, strategy=strategy, seed=seed,
            anneal_iters=anneal_iters, congestion_weight=congestion_weight,
            cache=_cache, stats=_stats, faults=faults if topo else None)
        _, local_dist, _ = PL._local_tables(l2w, False)
        baseline = PL.hierarchical_cost(
            PL.contiguous_place(groups, su.core_slots), flows,
            local_dist, l2w)
        if topo:
            # local-path composition assumes the healthy local graph;
            # a faulty fabric routes flat on the masked global adjacency
            routed = _route_or_raise(groups, placement.assignment,
                                     adjacency, su.level2_nodes, faults)
        else:
            routed = R.route_hierarchical(groups, placement.assignment,
                                          su.adjacency, su.level2_nodes)
    else:
        dplan, dplacements = None, None
        core_slots = su.core_slots
        if dead:
            core_slots = np.array(
                [s for s in np.asarray(core_slots) if int(s) not in dead])
            if len(groups) > len(core_slots):
                raise ValueError(
                    f"{len(groups)} groups need more than the "
                    f"{len(core_slots)} surviving cores — no spare "
                    "capacity to remap dead cores onto")
        dist = PL.weighted_distances(adjacency, su.level2_nodes,
                                     spec.interconnect.level2_premium())
        placement = PL.place(groups, flows, dist, core_slots, spec,
                             su.n_domains, strategy=strategy, seed=seed,
                             anneal_iters=anneal_iters,
                             adjacency=adjacency,
                             congestion_weight=congestion_weight)
        baseline = PL.placement_cost(
            PL.contiguous_place(groups, core_slots), flows, dist)
        routed = (_route_or_raise(groups, placement.assignment, adjacency,
                                  su.level2_nodes, faults) if topo
                  else R.route(groups, placement.assignment, su.adjacency,
                               su.level2_nodes))
    compiled = CompiledNetwork(net=graph, spec=spec, groups=groups,
                               placement=placement, plan=su, routed=routed,
                               baseline_cost=baseline, domain_plan=dplan,
                               domain_placements=dplacements,
                               hierarchical=hier, options=options,
                               faults=faults)
    if verify:
        verify_roundtrip(routed)
    return compiled


def _route_or_raise(groups, assignment, adjacency, level2_nodes, faults):
    """Flat route on a fault-masked adjacency, with unroutable pairs
    surfaced as ValueError (the surviving graph is partitioned) instead
    of the routing table's bare assertion."""
    try:
        return R.route(groups, assignment, adjacency, level2_nodes)
    except AssertionError as e:
        raise ValueError(
            f"faults {faults.describe()} disconnect the surviving fabric: "
            f"{e}") from e


def recompile(net: Any, prev: CompiledNetwork,
              changed_layers: Any = None, **overrides) -> CompiledNetwork:
    """Incrementally recompile an edited network against a previous
    hierarchical compile.

    Runs the full pipeline (so the result is bit-identical to a fresh
    `compile_network` of the edited network — correctness never depends
    on the edit description), but seeds the per-domain placement cache
    with `prev`'s solved subproblems: any domain whose content hash is
    unchanged reuses its `DomainPlacement` by object identity and skips
    its anneal, which is where nearly all compile time goes.

    `changed_layers` is an optional hint (iterable of layer indices)
    recorded in `recompile_stats` for telemetry; keyword overrides
    replace individual compile options from the previous run.
    """
    opts = dict(prev.options or {})
    opts.pop("hierarchical", None)
    opts.update(overrides)
    hier = opts.pop("hierarchical", prev.hierarchical or None)
    cache = {dp.cache_key: dp
             for dp in (prev.domain_placements or {}).values()}
    stats: dict = {}
    compiled = compile_network(
        net, prev.spec, hierarchical=hier,
        _cache=cache or None, _stats=stats, **opts)
    stats.setdefault("domains", compiled.plan.n_domains)
    stats.setdefault("reused", 0)
    stats["changed_layers"] = (sorted(int(li) for li in changed_layers)
                               if changed_layers is not None else None)
    compiled.recompile_stats = stats
    return compiled


def repair(net: Any, prev: CompiledNetwork, faults: Any,
           **overrides) -> CompiledNetwork:
    """Recompile `net` around a FaultConfig, reusing `prev`'s placements.

    The repaired compile reroutes every flow on the fault-masked graph
    (failed routers/links become BFS detours) and remaps dead cores'
    neuron slices onto spare capacity.  Runs the full pipeline — the
    result is bit-identical to `compile_network(net, faults=...)` — but
    seeds the per-domain cache from `prev`, and since only domains that
    lost a core get new cache keys, a router or link failure reuses
    EVERY domain placement and pays only for rerouting (`fault_bench.py`
    gates this as `fault.repair_speedup`).

    The result carries `faults.with_rerouted()`: build the simulator with
    `ChipSimulator(..., mapping=repaired.to_soc_mapping(),
    faults=repaired.faults)` so its fabric masks match the reprogrammed
    routes.  Raises ValueError when the surviving graph cannot host or
    route the network.
    """
    return recompile(net, prev, faults=faults.with_rerouted(), **overrides)
