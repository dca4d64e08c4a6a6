"""Stage 2 — place: assign core groups to physical cores, minimizing the
hop-weighted spike-traffic cost on the fullerene topology.

Cost of a placement P is

    cost(P) = sum over flows (g -> h, w)  of  w * dist[P(g), P(h)]

where `dist` is the energy-weighted shortest-path hop matrix: on-chip
links cost 1, links through a level-2 router cost the off-chip premium
(E.InterconnectEnergyModel.level2_premium()), so the optimizer keeps
chatty layer pairs inside one domain.

Strategies:
  * "contiguous" — layers onto cores in id order, the old soc.map_network
    behaviour (baseline; ignores traffic entirely).
  * "greedy"     — traffic-aware seed: groups in descending traffic order,
    each onto the free core minimizing incremental cost.
  * "anneal"     — the greedy seed refined by simulated annealing (random
    swap/relocate moves, Metropolis acceptance, geometric cooling).
    Deterministic given `seed`.

Congestion-aware mode: `congestion_weight > 0` adds the bottleneck
CMRouter's spike occupancy (the same per-path router-load accounting the
engines' `noc.FlowTable` replays exactly) to the anneal objective —
hop-cost alone can pile chatty groups around one router, which the
engines now surface as `noc_contention_cycles`; the weighted objective
trades a few hops for a flatter router-load profile.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq

import numpy as np

from repro_torch.compiler.ir import ChipSpec
from repro_torch.compiler.partition import CoreGroup, DomainPlan

# pseudo-gid for a domain's level-2 portal in local placement flows: the
# constant-distance endpoint cross-domain traffic enters/leaves through
PORTAL = -1


def weighted_distances(adj: np.ndarray, level2_nodes: frozenset[int],
                       l2_weight: float) -> np.ndarray:
    """All-pairs shortest paths with level-2-incident links costing
    `l2_weight` instead of 1 (Dijkstra per source; graphs are <= a few
    hundred nodes)."""
    n = adj.shape[0]
    nbrs = [np.nonzero(adj[i])[0] for i in range(n)]
    out = np.full((n, n), np.inf)
    for s in range(n):
        dist = out[s]
        dist[s] = 0.0
        heap = [(0.0, s)]
        while heap:
            d, u = heapq.heappop(heap)
            if d > dist[u]:
                continue
            for v in nbrs[u]:
                w = l2_weight if (u in level2_nodes or v in level2_nodes) else 1.0
                nd = d + w
                if nd < dist[v]:
                    dist[v] = nd
                    heapq.heappush(heap, (nd, int(v)))
    return out


@dataclasses.dataclass
class Placement:
    """gid -> physical core node id, plus the cost bookkeeping.

    `congestion` is the bottleneck router's expected spike occupancy per
    timestep under the group-traffic weights (0.0 when not evaluated);
    `congestion_weight` records the knob the optimizer ran with.
    """

    assignment: dict[int, int]
    cost: float
    strategy: str
    n_domains: int
    congestion: float = 0.0
    congestion_weight: float = 0.0

    def core_of(self, gid: int) -> int:
        return self.assignment[gid]


def placement_cost(assignment: dict[int, int],
                   flows: list[tuple[int, int, float]],
                   dist: np.ndarray) -> float:
    return float(sum(w * dist[assignment[s], assignment[d]]
                     for s, d, w in flows))


def path_load_table(adj: np.ndarray) -> np.ndarray:
    """Per-spike router occupancy of every routed (src, dst) pair.

    `load[u, v, r]` counts how often the programmed shortest path u -> v
    occupies node `r` as a sender — the same sender-charging convention
    as `noc.FlowTable.router_load`.  Placement flows are *pairwise*, so a
    source that fans out to k groups charges shared upstream links k
    times where the engines' broadcast replay (link union per FlowRoute)
    charges them once: the prediction is an upper bound on the replayed
    bottleneck, tight for P2P traffic.
    """
    from repro_torch.core import noc as NOC

    rt = NOC.RoutingTable(adj)
    n = adj.shape[0]
    load = np.zeros((n, n, n), np.float32)
    for u in range(n):
        for v in range(n):
            if u == v:
                continue
            for node in rt.path(u, v)[:-1]:
                load[u, v, node] += 1
    return load


def congestion_cost(assignment: dict[int, int],
                    flows: list[tuple[int, int, float]],
                    path_load: np.ndarray) -> float:
    """Bottleneck-router spike occupancy of the placed pairwise traffic
    (see `path_load_table` for the broadcast-sharing caveat)."""
    if not flows:
        return 0.0
    load = np.zeros(path_load.shape[0])
    for s, d, w in flows:
        load += w * path_load[assignment[s], assignment[d]]
    return float(load.max())


def placed_congestion(assignment: dict[int, int],
                      flows: list[tuple[int, int, float]],
                      adj: np.ndarray) -> float:
    """`congestion_cost` for ONE final placement, without materializing
    the (n, n, n) `path_load_table` — walks only the F assigned paths.
    Same sender-charging convention; used to record
    `Placement.congestion` on every compile cheaply."""
    from repro_torch.core import noc as NOC

    if not flows:
        return 0.0
    rt = NOC.RoutingTable(adj)
    load = np.zeros(adj.shape[0])
    for s, d, w in flows:
        u, v = assignment[s], assignment[d]
        if u == v:
            continue
        for node in rt.path(u, v)[:-1]:
            load[node] += w
    return float(load.max())


def contiguous_place(groups: list[CoreGroup], core_slots: np.ndarray
                     ) -> dict[int, int]:
    """Layer-order onto core-id-order: the greedy soc.map_network layout."""
    return {g.gid: int(core_slots[i]) for i, g in enumerate(groups)}


def greedy_place(groups: list[CoreGroup],
                 flows: list[tuple[int, int, float]],
                 dist: np.ndarray, core_slots: np.ndarray) -> dict[int, int]:
    """Traffic-aware constructive seed."""
    # per-group flow lists for incremental cost
    touching: dict[int, list[tuple[int, float]]] = {g.gid: [] for g in groups}
    for s, d, w in flows:
        touching[s].append((d, w))
        touching[d].append((s, w))
    order = sorted(groups,
                   key=lambda g: -sum(w for _, w in touching[g.gid]))
    free = [int(c) for c in core_slots]
    # centrality: prefer cores with low mean distance to other cores
    centrality = dist[np.ix_(core_slots, core_slots)].mean(axis=1)
    by_central = {int(c): float(centrality[i])
                  for i, c in enumerate(core_slots)}
    assignment: dict[int, int] = {}
    for g in order:
        best, best_cost = None, np.inf
        for c in free:
            inc = sum(w * dist[c, assignment[o]]
                      for o, w in touching[g.gid] if o in assignment)
            # tie-break toward central cores so early groups cluster
            inc += 1e-6 * by_central[c]
            if inc < best_cost:
                best, best_cost = c, inc
        assignment[g.gid] = best
        free.remove(best)
    return assignment


def anneal_place(assignment: dict[int, int],
                 flows: list[tuple[int, int, float]],
                 dist: np.ndarray, core_slots: np.ndarray,
                 seed: int = 0, iters: int = 4000,
                 t0: float | None = None, t_end: float = 1e-3,
                 path_load: np.ndarray | None = None,
                 congestion_weight: float = 0.0,
                 pinned: frozenset[int] = frozenset()) -> dict[int, int]:
    """Refine by simulated annealing over swap/relocate moves.

    With `congestion_weight > 0` (and a `path_load` table) the objective
    becomes hop-cost + weight * bottleneck-router occupancy; the
    congestion term is global (a max over routers), so it is re-evaluated
    per candidate move instead of delta-tracked.  `pinned` gids stay at
    their seed nodes (hierarchical placement pins the level-2 portal).
    """
    rng = np.random.default_rng(seed)
    gids = [g for g in assignment if g not in pinned]
    occupied = dict(assignment)
    used = set(occupied.values())
    free = [int(c) for c in core_slots if c not in used]
    cost = placement_cost(occupied, flows, dist)
    congested = congestion_weight > 0.0 and path_load is not None
    cong = congestion_cost(occupied, flows, path_load) if congested else 0.0
    # flows grouped per gid for delta evaluation (pinned gids appear as
    # partners but are never moved)
    touching: dict[int, list[tuple[int, float]]] = {g: [] for g in occupied}
    for s, d, w in flows:
        touching[s].append((d, w))
        touching[d].append((s, w))

    def local_cost(gid: int, at: int, asg: dict[int, int]) -> float:
        return sum(w * dist[at, asg[o]] for o, w in touching[gid] if o != gid)

    def cong_delta() -> tuple[float, float]:
        """(objective delta, new congestion) for the already-applied move."""
        if not congested:
            return 0.0, 0.0
        new_cong = congestion_cost(occupied, flows, path_load)
        return congestion_weight * (new_cong - cong), new_cong

    t0 = t0 if t0 is not None else max(cost / max(len(gids), 1), 1.0)
    obj = cost + congestion_weight * cong
    best, best_obj = dict(occupied), obj
    for it in range(iters):
        temp = t0 * (t_end / t0) ** (it / max(iters - 1, 1))
        if free and rng.random() < 0.3:
            # relocate a random group to a random free core
            g = gids[int(rng.integers(len(gids)))]
            c_new = free[int(rng.integers(len(free)))]
            c_old = occupied[g]
            delta = local_cost(g, c_new, occupied) - local_cost(g, c_old, occupied)
            occupied[g] = c_new
            cdelta, new_cong = cong_delta()
            delta += cdelta
            if delta < 0 or rng.random() < np.exp(-delta / max(temp, 1e-12)):
                free.remove(c_new)
                free.append(c_old)
                obj += delta
                cong = new_cong if congested else cong
            else:
                occupied[g] = c_old
        else:
            # swap two groups' cores
            i, j = rng.integers(len(gids)), rng.integers(len(gids))
            if i == j:
                continue
            ga, gb = gids[int(i)], gids[int(j)]
            ca, cb = occupied[ga], occupied[gb]
            before = local_cost(ga, ca, occupied) + local_cost(gb, cb, occupied)
            occupied[ga], occupied[gb] = cb, ca
            after = local_cost(ga, cb, occupied) + local_cost(gb, ca, occupied)
            delta = after - before
            cdelta, new_cong = cong_delta()
            delta += cdelta
            if delta < 0 or rng.random() < np.exp(-delta / max(temp, 1e-12)):
                obj += delta
                cong = new_cong if congested else cong
            else:
                occupied[ga], occupied[gb] = ca, cb
        if obj < best_obj:
            best, best_obj = dict(occupied), obj
    return best


def place(groups: list[CoreGroup], flows: list[tuple[int, int, float]],
          dist: np.ndarray, core_slots: np.ndarray, spec: ChipSpec,
          n_domains: int, strategy: str = "anneal", seed: int = 0,
          anneal_iters: int = 4000, adjacency: np.ndarray | None = None,
          congestion_weight: float = 0.0) -> Placement:
    """Place core groups.  `congestion_weight > 0` (needs `adjacency`)
    adds the bottleneck-router occupancy to the anneal objective; the
    resulting Placement always records its `congestion` when `adjacency`
    is available, whatever the weight.  The full (n, n, n) path-load
    table (random lookups for anneal moves) is only built when the
    weight is active."""
    if congestion_weight > 0.0 and strategy != "anneal":
        raise ValueError(
            f"congestion_weight is an anneal-objective knob; "
            f"strategy {strategy!r} would silently ignore it")
    if congestion_weight > 0.0 and adjacency is None:
        raise ValueError("congestion_weight > 0 needs the adjacency matrix")
    path_load = (path_load_table(adjacency)
                 if congestion_weight > 0.0 else None)
    if strategy == "contiguous":
        asg = contiguous_place(groups, core_slots)
    elif strategy == "greedy":
        asg = greedy_place(groups, flows, dist, core_slots)
    elif strategy == "anneal":
        seeds = (greedy_place(groups, flows, dist, core_slots),
                 contiguous_place(groups, core_slots))
        asg = min(seeds, key=lambda a: placement_cost(a, flows, dist))
        asg = anneal_place(asg, flows, dist, core_slots,
                           seed=seed, iters=anneal_iters,
                           path_load=path_load,
                           congestion_weight=congestion_weight)
    else:
        raise ValueError(f"unknown placement strategy {strategy!r}")
    return Placement(assignment=asg,
                     cost=placement_cost(asg, flows, dist),
                     strategy=strategy, n_domains=n_domains,
                     congestion=(placed_congestion(asg, flows, adjacency)
                                 if adjacency is not None else 0.0),
                     congestion_weight=congestion_weight)


# ---------------------------------------------------------------------------
# hierarchical placement: one independent subproblem per level-1 domain
# ---------------------------------------------------------------------------
#
# On the fullerene graph every core is adjacent to >= 1 level-1 router and
# the level-2 router is adjacent to ALL level-1 routers, so each core sits
# at weighted distance (1 + l2_weight) from its domain's level-2 node and
# the distance between cores in *different* domains is the constant
# 2 + 3 * l2_weight, independent of which local slots they occupy.  The
# global hop-weighted cost therefore decomposes exactly:
#
#     cost(P) = sum_d local_cost_d(P)  +  cross_traffic * (2 + 3 * l2w)
#
# which is what lets the anneal run per domain on a shared 33-node local
# distance table (and a 33^3 path-load table in congestion mode) instead
# of the global O((33 D)^3) one.

def derive_domain_seed(seed: int, domain: int) -> int:
    """Stable per-domain RNG seed: independent anneal streams per domain,
    reproducible across processes (no global NumPy state involved)."""
    return int(np.random.SeedSequence([int(seed), int(domain)])
               .generate_state(1)[0])


def cross_domain_distance(l2_weight: float) -> float:
    """Weighted distance between cores of different domains (constant)."""
    return 2.0 + 3.0 * float(l2_weight)


def hierarchical_cost(assignment: dict[int, int],
                      flows: list[tuple[int, int, float]],
                      local_dist: np.ndarray, l2_weight: float) -> float:
    """`placement_cost` evaluated through the per-domain decomposition —
    equal to the flat global-table cost, without building that table."""
    from repro_torch.core import noc as NOC

    stride = NOC.DOMAIN_STRIDE
    cross = cross_domain_distance(l2_weight)
    total = 0.0
    for s, t, w in flows:
        u, v = assignment[s], assignment[t]
        if u // stride == v // stride:
            total += w * local_dist[u % stride, v % stride]
        else:
            total += w * cross
    return float(total)


@dataclasses.dataclass(frozen=True)
class DomainPlacement:
    """One domain's solved subproblem, reusable across recompiles.

    ``slots[i]`` is the local node id (12..31) of the domain's i-th group
    in ascending-gid order — local indices, not gids, so the object stays
    valid when an edit elsewhere renumbers gids without changing this
    domain's content.  ``cache_key`` hashes everything the subproblem
    depends on (canonical groups, local flows, portal traffic, derived
    seed, anneal knobs); `recompile` reuses the object verbatim on a key
    hit.
    """

    domain: int
    slots: tuple[int, ...]
    cost: float                 # intra-domain hop-weighted traffic cost
    congestion: float           # local bottleneck incl. portal/L2 charges
    cache_key: str


def _local_tables(l2_weight: float, need_path_load: bool
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """(local adjacency, local weighted distances, local path-load table)
    for one 33-node fullerene domain + its level-2 router.  Cached: the
    local graph is identical for every domain, which is the whole point."""
    from repro_torch.core import noc as NOC

    key = (round(float(l2_weight), 12), need_path_load)
    hit = _local_tables._cache.get(key)
    if hit is not None:
        return hit
    adj = NOC.fullerene_adjacency(with_level2=True)
    dist = weighted_distances(adj, frozenset({NOC.N_NODES}), l2_weight)
    pl = path_load_table(adj) if need_path_load else None
    _local_tables._cache[key] = (adj, dist, pl)
    return adj, dist, pl


_local_tables._cache = {}


def _domain_congestion(asg: dict[int, int],
                       intra: list[tuple[int, int, float]],
                       portal_out: list[tuple[int, float]],
                       portal_in: list[tuple[int, float]],
                       local_rt) -> float:
    """Local bottleneck-router occupancy with the same sender-charging
    convention as `placed_congestion` on the flat multi-domain graph:
    portal paths charge up to (not including) the level-2 node, outbound
    cross traffic additionally charges the local level-2 node as the
    sender of its L2->L2 hop, and inbound cross traffic charges the
    level-2 node via the (L2 -> core) local path."""
    from repro_torch.core import noc as NOC

    load = np.zeros(NOC.N_NODES + 1)
    for s, t, w in intra:
        u, v = asg[s], asg[t]
        if u == v:
            continue
        for node in local_rt.path(u, v)[:-1]:
            load[node] += w
    for g, w in portal_out:
        for node in local_rt.path(asg[g], NOC.N_NODES)[:-1]:
            load[node] += w
        load[NOC.N_NODES] += w            # sender of the L2 -> L2 hop
    for g, w in portal_in:
        for node in local_rt.path(NOC.N_NODES, asg[g])[:-1]:
            load[node] += w
    return float(load.max())


def domain_cache_key(groups: list[CoreGroup],
                     intra: list[tuple[int, int, float]],
                     portal_out: list[tuple[int, float]],
                     portal_in: list[tuple[int, float]],
                     derived_seed: int, strategy: str, anneal_iters: int,
                     congestion_weight: float, l2_weight: float,
                     dead_slots: tuple = ()) -> str:
    """Content hash of one domain subproblem, over gid-free canonical
    forms (flows re-expressed through local group indices) so renumbering
    untouched layers cannot invalidate the cache.  `dead_slots` (local
    slot ids a repaired chip may not use) extends the canon only when
    non-empty, so fault-free domains keep their historical keys — which
    is what makes `compiler.repair` reuse untouched domains for free."""
    gids = sorted(g.gid for g in groups)
    local = {g: i for i, g in enumerate(gids)}
    by_gid = {g.gid: g for g in groups}
    canon = (
        tuple((by_gid[g].layer, by_gid[g].lo, by_gid[g].hi) for g in gids),
        tuple(sorted((local[s], local[t], round(w, 12)) for s, t, w in intra)),
        tuple(sorted((local[g], round(w, 12)) for g, w in portal_out)),
        tuple(sorted((local[g], round(w, 12)) for g, w in portal_in)),
        int(derived_seed), str(strategy), int(anneal_iters),
        round(float(congestion_weight), 12), round(float(l2_weight), 12),
    )
    if dead_slots:
        canon = canon + (tuple(sorted(int(s) for s in dead_slots)),)
    return hashlib.sha256(repr(canon).encode()).hexdigest()


def _place_one_domain(groups: list[CoreGroup],
                      intra: list[tuple[int, int, float]],
                      portal_out: list[tuple[int, float]],
                      portal_in: list[tuple[int, float]],
                      derived_seed: int, strategy: str, anneal_iters: int,
                      congestion_weight: float, l2_weight: float,
                      dead_slots: frozenset[int] = frozenset()
                      ) -> tuple[tuple[int, ...], float]:
    """Solve one local subproblem; returns (slots in gid order, cost).
    `dead_slots` removes local core slots a repaired chip may not use."""
    from repro_torch.core import noc as NOC

    _, local_dist, path_load = _local_tables(
        l2_weight, congestion_weight > 0.0)
    slots = NOC.core_ids()
    if dead_slots:
        slots = np.array([s for s in slots if int(s) not in dead_slots])
        if len(groups) > len(slots):
            raise ValueError(
                f"{len(groups)} groups need more than the {len(slots)} "
                f"surviving cores of this domain — no spare capacity to "
                f"remap dead cores onto")
    gids = sorted(g.gid for g in groups)
    order = {g: i for i, g in enumerate(gids)}
    sorted_groups = sorted(groups, key=lambda g: g.gid)
    if strategy == "anneal":
        seeds = (greedy_place(sorted_groups, intra, local_dist, slots),
                 contiguous_place(sorted_groups, slots))
        asg = min(seeds, key=lambda a: placement_cost(a, intra, local_dist))
        pinned = frozenset()
        flows = intra
        if congestion_weight > 0.0 and (portal_out or portal_in):
            # portal flows are hop-cost constants (every core is equidistant
            # from the level-2 node) but they do shape router load, so they
            # join the objective only in congestion mode
            asg = dict(asg)
            asg[PORTAL] = NOC.N_NODES
            pinned = frozenset({PORTAL})
            flows = (intra
                     + [(g, PORTAL, w) for g, w in portal_out]
                     + [(PORTAL, g, w) for g, w in portal_in])
        asg = anneal_place(asg, flows, local_dist, slots,
                           seed=derived_seed, iters=anneal_iters,
                           path_load=path_load,
                           congestion_weight=congestion_weight,
                           pinned=pinned)
        asg.pop(PORTAL, None)
    elif strategy == "greedy":
        asg = greedy_place(sorted_groups, intra, local_dist, slots)
    elif strategy == "contiguous":
        asg = contiguous_place(sorted_groups, slots)
    else:
        raise ValueError(f"unknown placement strategy {strategy!r}")
    cost = placement_cost(asg, intra, local_dist)
    return tuple(asg[g] for g in sorted(order, key=order.get)), cost


def place_hierarchical(groups: list[CoreGroup],
                       flows: list[tuple[int, int, float]],
                       dplan: DomainPlan, spec: ChipSpec,
                       strategy: str = "anneal", seed: int = 0,
                       anneal_iters: int = 4000,
                       congestion_weight: float = 0.0,
                       cache: dict[str, DomainPlacement] | None = None,
                       stats: dict | None = None,
                       faults=None
                       ) -> tuple[Placement, dict[int, DomainPlacement]]:
    """Place each domain's groups independently on the shared 33-node
    local graph, then stitch the global Placement back together.

    `cache` maps `DomainPlacement.cache_key` to previously solved
    subproblems (see `recompile`); hits are returned by object identity.
    `stats`, when given, receives {"domains": D, "reused": k}.
    `faults` (a faults.FaultConfig) removes dead cores' slots from their
    domains; only those domains get extended cache keys, so a repair
    reuses every untouched domain's placement verbatim.
    """
    from repro_torch.core import noc as NOC

    l2w = spec.interconnect.level2_premium()
    _, local_dist, _ = _local_tables(l2w, False)
    local_rt = NOC.RoutingTable(NOC.fullerene_adjacency(with_level2=True))
    intra, cross = dplan.split_flows(flows)
    by_gid = {g.gid: g for g in groups}
    dead_local: dict[int, set[int]] = {}
    for c in (faults.dead_cores if faults is not None else ()):
        dom, loc = divmod(int(c), NOC.DOMAIN_STRIDE)
        dead_local.setdefault(dom, set()).add(loc)

    assignment: dict[int, int] = {}
    placements: dict[int, DomainPlacement] = {}
    total_cost = dplan.cross_traffic * cross_domain_distance(l2w)
    congestion = 0.0
    reused = 0
    for d in range(dplan.n_domains):
        gids = dplan.gids_of(d)
        if not gids:
            continue
        dgroups = [by_gid[g] for g in gids]
        out_w: dict[int, float] = {}
        in_w: dict[int, float] = {}
        for s, t, w in cross:
            if dplan.domain_of[s] == d:
                out_w[s] = out_w.get(s, 0.0) + w
            if dplan.domain_of[t] == d:
                in_w[t] = in_w.get(t, 0.0) + w
        portal_out = sorted(out_w.items())
        portal_in = sorted(in_w.items())
        dseed = derive_domain_seed(seed, d)
        dead = frozenset(dead_local.get(d, ()))
        key = domain_cache_key(dgroups, intra[d], portal_out, portal_in,
                               dseed, strategy, anneal_iters,
                               congestion_weight, l2w,
                               dead_slots=tuple(sorted(dead)))
        hit = cache.get(key) if cache else None
        if hit is not None:
            dp = dataclasses.replace(hit, domain=d) if hit.domain != d else hit
            reused += 1
        else:
            slots, cost = _place_one_domain(
                dgroups, intra[d], portal_out, portal_in, dseed, strategy,
                anneal_iters, congestion_weight, l2w, dead_slots=dead)
            asg = {g: s for g, s in zip(gids, slots)}
            dp = DomainPlacement(
                domain=d, slots=slots, cost=cost,
                congestion=_domain_congestion(asg, intra[d], portal_out,
                                              portal_in, local_rt),
                cache_key=key)
        placements[d] = dp
        for g, s in zip(gids, dp.slots):
            assignment[g] = d * NOC.DOMAIN_STRIDE + s
        total_cost += dp.cost
        congestion = max(congestion, dp.congestion)
    if stats is not None:
        stats["domains"] = len(placements)
        stats["reused"] = reused
    return (Placement(assignment=assignment, cost=float(total_cost),
                      strategy=strategy, n_domains=dplan.n_domains,
                      congestion=congestion,
                      congestion_weight=congestion_weight),
            placements)
