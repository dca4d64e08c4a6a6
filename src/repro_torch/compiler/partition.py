"""Stage 1 — partition: split layers into core-sized neuron groups.

Each group lives on exactly one physical core and therefore shares one
weight codebook (paper C3), so groups never mix layers.  Within a layer
the split is *balanced* (sizes differ by at most one neuron) rather than
greedy-full-cores: balanced slices equalize per-core synapse work, which
is what the ZSPE cycle model rewards (wall cycles = max over cores).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.compiler.ir import ChipSpec, NetworkGraph


@dataclasses.dataclass(frozen=True)
class CoreGroup:
    """A contiguous neuron slice [lo, hi) of one layer, one core's worth."""

    gid: int
    layer: int
    lo: int
    hi: int

    @property
    def n_neurons(self) -> int:
        return self.hi - self.lo


def _groups_per_layer(net: NetworkGraph, spec: ChipSpec,
                      spread: bool) -> list[int]:
    """How many cores each placed layer gets.

    The minimum is capacity-driven (ceil(n / 8192)).  With `spread`, idle
    cores of the needed domain count are handed out one at a time to the
    layer with the most neurons per group — parallelizing big layers cuts
    wall cycles (the ZSPE cycle model takes the max over cores) at the
    price of extra NoC fan-out, which the placement stage then minimizes.
    """
    mins = [math.ceil(l.n_neurons / spec.neurons_per_core)
            for l in net.placed_layers]
    total_cores = spec.domains_needed(sum(mins)) * spec.n_cores
    if sum(mins) > spec.max_domains * spec.n_cores:
        raise ValueError(
            f"network needs {sum(mins)} cores but only "
            f"{spec.max_domains * spec.n_cores} are available "
            f"({spec.max_domains} domain(s) x {spec.n_cores}); "
            f"layer sizes {net.layer_sizes()}")
    counts = list(mins)
    if not spread:
        return counts
    sizes = [l.n_neurons for l in net.placed_layers]
    extra = min(total_cores, spec.max_domains * spec.n_cores) - sum(counts)
    for _ in range(extra):
        per_group = [(n / c if c < n else 0.0, i)
                     for i, (n, c) in enumerate(zip(sizes, counts))]
        density, i = max(per_group)
        if density <= 0:
            break                       # every layer already 1 neuron/core
        counts[i] += 1
    return counts


def partition(net: NetworkGraph, spec: ChipSpec,
              spread: bool = True) -> list[CoreGroup]:
    """Split every placed layer into <= neurons_per_core groups.

    Raises ValueError when the network exceeds the chip's total neuron
    capacity or needs more cores than `max_domains` domains provide.
    """
    spec.validate_network(net)
    counts = _groups_per_layer(net, spec, spread)
    groups: list[CoreGroup] = []
    gid = 0
    for layer, n_groups in zip(net.placed_layers, counts):
        base, extra = divmod(layer.n_neurons, n_groups)
        lo = 0
        for g in range(n_groups):
            take = base + (1 if g < extra else 0)
            groups.append(CoreGroup(gid=gid, layer=layer.index,
                                    lo=lo, hi=lo + take))
            gid += 1
            lo += take
        assert lo == layer.n_neurons
    return groups


@dataclasses.dataclass(frozen=True)
class DomainPlan:
    """Chip/domain grouping: which level-1 domain each core group lives in.

    This is the hierarchy's top cut (Davies-style partition-then-place):
    once the domain of every group is fixed, per-domain placement
    subproblems are *independent* — on the fullerene graph every core sits
    at the same weighted distance from its domain's level-2 router, so the
    cross-domain distance between any two cores is a constant and the
    global hop-weighted cost decomposes into per-domain local costs plus
    ``cross_traffic`` times that constant.  ``flow_summary`` is the small
    inter-domain matrix the scale-up/route stages consume instead of any
    global O(n^3) table.
    """

    n_domains: int
    domain_of: dict[int, int]          # gid -> domain index
    cross_traffic: float               # spikes/step crossing a domain edge
    flow_summary: tuple[tuple[float, ...], ...]   # (D, D) inter-domain rates

    def gids_of(self, domain: int) -> list[int]:
        return sorted(g for g, d in self.domain_of.items() if d == domain)

    def split_flows(self, flows: list[tuple[int, int, float]]
                    ) -> tuple[dict[int, list[tuple[int, int, float]]],
                               list[tuple[int, int, float]]]:
        """(per-domain intra flows, cross-domain flows)."""
        intra: dict[int, list[tuple[int, int, float]]] = {
            d: [] for d in range(self.n_domains)}
        cross: list[tuple[int, int, float]] = []
        for s, t, w in flows:
            ds, dt = self.domain_of[s], self.domain_of[t]
            if ds == dt:
                intra[ds].append((s, t, w))
            else:
                cross.append((s, t, w))
        return intra, cross


def assign_domains(groups: list[CoreGroup],
                   flows: list[tuple[int, int, float]],
                   spec: ChipSpec,
                   n_domains: int | None = None,
                   refine_passes: int = 6,
                   capacity: dict[int, int] | None = None) -> DomainPlan:
    """Group core groups into level-1 domains, minimizing cross-domain
    spike traffic under the per-domain core-count capacity.

    Seed: contiguous fill in gid order (groups are emitted layer by layer,
    and feed-forward traffic only couples consecutive layers, so
    contiguity is already near-optimal).  Refinement: deterministic
    first-improvement sweeps moving single groups into domains with free
    slots whenever that strictly lowers cross-domain traffic.

    `capacity` optionally lowers individual domains' core budgets below
    `spec.n_cores` (a repaired chip with dead cores — see
    `compiler.repair`); omitted domains keep the full budget.
    """
    if n_domains is None:
        n_domains = spec.domains_needed(len(groups))
    cap = spec.n_cores
    caps = [cap] * n_domains
    for d, c in (capacity or {}).items():
        if not 0 <= int(d) < n_domains:
            raise ValueError(f"capacity for domain {d} outside "
                             f"0..{n_domains - 1}")
        caps[int(d)] = min(cap, int(c))
    if len(groups) > sum(caps):
        raise ValueError(
            f"{len(groups)} groups exceed the {sum(caps)} usable cores of "
            f"{n_domains} domain(s)")
    # contiguous fill in gid order, honouring per-domain capacity
    # (identical to the historical i // cap fill when no cap is lowered)
    domain_of: dict[int, int] = {}
    d = 0
    seed_fill = [0] * n_domains
    for g in groups:
        while seed_fill[d] >= caps[d]:
            d += 1
        domain_of[g.gid] = d
        seed_fill[d] += 1

    # per-group traffic affinity toward each domain, kept incremental
    touching: dict[int, list[tuple[int, float]]] = {g.gid: [] for g in groups}
    for s, t, w in flows:
        touching[s].append((t, w))
        touching[t].append((s, w))
    fill = [0] * n_domains
    for d in domain_of.values():
        fill[d] += 1

    def affinity(gid: int, dom: int) -> float:
        return sum(w for o, w in touching[gid] if domain_of[o] == dom)

    for _ in range(max(refine_passes, 0)):
        improved = False
        for g in groups:
            home = domain_of[g.gid]
            aff_home = affinity(g.gid, home)
            for dom in range(n_domains):
                if dom == home or fill[dom] >= caps[dom]:
                    continue
                if affinity(g.gid, dom) > aff_home + 1e-12:
                    fill[home] -= 1
                    fill[dom] += 1
                    domain_of[g.gid] = dom
                    improved = True
                    break
        if not improved:
            break

    summary = [[0.0] * n_domains for _ in range(n_domains)]
    cross = 0.0
    for s, t, w in flows:
        ds, dt = domain_of[s], domain_of[t]
        summary[ds][dt] += w
        if ds != dt:
            cross += w
    return DomainPlan(n_domains=n_domains, domain_of=dict(domain_of),
                      cross_traffic=cross,
                      flow_summary=tuple(tuple(r) for r in summary))


def group_traffic(net: NetworkGraph, groups: list[CoreGroup]
                  ) -> list[tuple[int, int, float]]:
    """Inter-group spike flows: [(src_gid, dst_gid, spikes_per_timestep)].

    Feed-forward connectivity is dense between consecutive layers, so every
    spike a source group emits must reach *every* group of the next layer
    (each holds a slice of the postsynaptic population).  A source group's
    share of its layer's traffic is proportional to its neuron share.
    """
    by_layer: dict[int, list[CoreGroup]] = {}
    for g in groups:
        by_layer.setdefault(g.layer, []).append(g)
    flows: list[tuple[int, int, float]] = []
    for layer in net.placed_layers[:-1]:
        srcs = by_layer[layer.index]
        dsts = by_layer[layer.index + 1]
        rate = net.spike_rates[layer.index]
        for s in srcs:
            share = rate * s.n_neurons / layer.n_neurons
            for d in dsts:
                flows.append((s.gid, d.gid, share))
    return flows
