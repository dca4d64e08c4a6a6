"""Fullerene-like NoC (paper C4): topology, CMRouter model, routing sim.

Topology.  The level-1 routing domain is the *face-vertex incidence graph of
the icosahedron* (equivalently: dodecahedron vertices + faces): 20 cores sit
on the dodecahedron's vertices (degree 3) and 12 CMRouters on its faces
(degree 5).  This graph has exactly the paper's published properties:

    average node degree       = (20*3 + 12*5) / 32 = 3.75     (paper: 3.75)
    node-degree variance      = 0.9375                        (paper: 0.93-0.94)
    avg core-to-core distance = 3.158 hops                    (paper: 3.16)

A level-2 router attaches to all 12 level-1 routers ("center point of the
topology") and bridges to other domains — the chip's scale-up path, which we
map onto the multi-pod "pod" mesh axis.

The CMRouter stores routes in an N_c x N_c x W_cid-bit *connection matrix*
(N_c = 5 neighbors, W_cid = 5-bit core ids) and supports P2P, broadcast and
merge transmission without packet en/decoding.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Iterable, Sequence

import numpy as np

N_CORES = 20
N_ROUTERS = 12
N_NODES = N_CORES + N_ROUTERS  # level-1 domain


# --------------------------------------------------------------------------
# Topology construction
# --------------------------------------------------------------------------

def _icosahedron_faces() -> list[tuple[int, int, int]]:
    """The 20 triangular faces of the icosahedron over 12 vertices."""
    phi = (1 + 5 ** 0.5) / 2
    verts = []
    for a, b in [(1, phi), (-1, phi), (1, -phi), (-1, -phi)]:
        verts += [(0, a, b), (a, b, 0), (b, 0, a)]
    v = np.array(verts)
    d = np.linalg.norm(v[:, None] - v[None, :], axis=-1)
    mind = np.min(d[d > 1e-9])
    edges = {
        frozenset((i, j))
        for i in range(12)
        for j in range(i + 1, 12)
        if abs(d[i, j] - mind) < 1e-6
    }
    faces = [
        f
        for f in itertools.combinations(range(12), 3)
        if all(frozenset(p) in edges for p in itertools.combinations(f, 2))
    ]
    assert len(faces) == N_CORES
    return faces


def fullerene_adjacency(with_level2: bool = False) -> np.ndarray:
    """Adjacency matrix of a level-1 domain.

    Node ids: routers 0..11, cores 12..31 (+ node 32 = level-2 router when
    ``with_level2``; it links to every level-1 router).
    """
    n = N_NODES + (1 if with_level2 else 0)
    a = np.zeros((n, n), dtype=np.int32)
    for ci, face in enumerate(_icosahedron_faces()):
        for vtx in face:
            a[vtx, N_ROUTERS + ci] = a[N_ROUTERS + ci, vtx] = 1
    if with_level2:
        for r in range(N_ROUTERS):
            a[N_NODES, r] = a[r, N_NODES] = 1
    return a


def core_ids() -> np.ndarray:
    return np.arange(N_ROUTERS, N_NODES)


def router_ids() -> np.ndarray:
    return np.arange(N_ROUTERS)


DOMAIN_STRIDE = N_NODES + 1   # nodes per domain block in a multi-domain graph


def multi_domain_adjacency(n_domains: int) -> np.ndarray:
    """Scale-up: `n_domains` fullerene domains, each with a level-2 router;
    level-2 routers are fully connected (the off-chip high-level ring/mesh).
    """
    base = fullerene_adjacency(with_level2=True)
    n = base.shape[0]
    a = np.zeros((n * n_domains, n * n_domains), dtype=np.int32)
    for d in range(n_domains):
        a[d * n:(d + 1) * n, d * n:(d + 1) * n] = base
    l2 = [d * n + N_NODES for d in range(n_domains)]
    for i, j in itertools.combinations(l2, 2):
        a[i, j] = a[j, i] = 1
    return a


def multi_domain_core_ids(n_domains: int) -> np.ndarray:
    """Global node ids of all cores across `n_domains` domains."""
    return np.concatenate(
        [d * DOMAIN_STRIDE + core_ids() for d in range(n_domains)])


def level2_node_ids(n_domains: int) -> np.ndarray:
    """Global node ids of the level-2 (off-chip high-level) routers."""
    return np.array([d * DOMAIN_STRIDE + N_NODES for d in range(n_domains)])


# --------------------------------------------------------------------------
# Comparison topologies (for the Fig. 5 study)
# --------------------------------------------------------------------------

def mesh_2d(rows: int, cols: int, torus: bool = False) -> np.ndarray:
    n = rows * cols
    a = np.zeros((n, n), dtype=np.int32)
    for i in range(rows):
        for j in range(cols):
            u = i * cols + j
            for di, dj in ((0, 1), (1, 0)):
                ii, jj = i + di, j + dj
                if torus:
                    ii, jj = ii % rows, jj % cols
                elif ii >= rows or jj >= cols:
                    continue
                a[u, ii * cols + jj] = a[ii * cols + jj, u] = 1
    return a


def tree(n: int, fanout: int = 2) -> np.ndarray:
    a = np.zeros((n, n), dtype=np.int32)
    for child in range(1, n):
        parent = (child - 1) // fanout
        a[child, parent] = a[parent, child] = 1
    return a


def ring(n: int) -> np.ndarray:
    a = np.zeros((n, n), dtype=np.int32)
    for i in range(n):
        a[i, (i + 1) % n] = a[(i + 1) % n, i] = 1
    return a


# --------------------------------------------------------------------------
# Graph metrics
# --------------------------------------------------------------------------

def bfs_distances(adj: np.ndarray) -> np.ndarray:
    n = adj.shape[0]
    dist = np.full((n, n), -1, dtype=np.int32)
    nbrs = [np.nonzero(adj[i])[0] for i in range(n)]
    for s in range(n):
        dist[s, s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for v in nbrs[u]:
                if dist[s, v] < 0:
                    dist[s, v] = dist[s, u] + 1
                    q.append(v)
    return dist


@dataclasses.dataclass(frozen=True)
class TopologyMetrics:
    name: str
    n_nodes: int
    avg_degree: float
    degree_variance: float
    avg_hops: float          # over all connected node pairs
    avg_core_hops: float     # over endpoint ("core") pairs only
    diameter: int
    bisection_links: int


def analyze(adj: np.ndarray, name: str, endpoints: Iterable[int] | None = None
            ) -> TopologyMetrics:
    deg = adj.sum(axis=1)
    dist = bfs_distances(adj)
    n = adj.shape[0]
    off = ~np.eye(n, dtype=bool)
    reach = (dist >= 0) & off
    ep = np.asarray(list(endpoints)) if endpoints is not None else np.arange(n)
    sub = dist[np.ix_(ep, ep)]
    sub_off = ~np.eye(len(ep), dtype=bool) & (sub >= 0)
    # simple bisection: split node ids in half, count crossing links
    half = n // 2
    bis = int(adj[:half, half:].sum())
    return TopologyMetrics(
        name=name,
        n_nodes=n,
        avg_degree=float(deg.mean()),
        degree_variance=float(deg.var()),
        avg_hops=float(dist[reach].mean()),
        avg_core_hops=float(sub[sub_off].mean()),
        diameter=int(dist[reach].max()),
        bisection_links=bis,
    )


def fullerene_metrics() -> TopologyMetrics:
    return analyze(fullerene_adjacency(), "fullerene", core_ids())


def comparison_table() -> list[TopologyMetrics]:
    """Fig. 5 comparison: fullerene vs mesh / torus / tree / ring at ~32 nodes."""
    return [
        fullerene_metrics(),
        analyze(mesh_2d(4, 8), "2d-mesh-4x8"),
        analyze(mesh_2d(6, 6), "2d-mesh-6x6"),
        analyze(mesh_2d(4, 8, torus=True), "torus-4x8"),
        analyze(tree(32, 2), "binary-tree-32"),
        analyze(ring(32), "ring-32"),
    ]


# --------------------------------------------------------------------------
# CMRouter + routing simulation
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RouterParams:
    """CMRouter characteristics (Fig. 4/5)."""

    n_neighbors: int = 5           # N_c
    core_id_bits: int = 5          # W_cid
    e_hop_p2p_pj: float = 0.026    # pJ per hop, P2P mode
    e_hop_bcast_pj: float = 0.009  # pJ per hop per destination, 1-to-3 bcast
    peak_throughput: float = 0.4   # spikes per cycle per router (best case)
    min_throughput: float = 0.2    # under contention

    def connection_matrix_bits(self) -> int:
        return self.n_neighbors * self.n_neighbors * self.core_id_bits


class RoutingTable:
    """Static shortest-path next-hop tables == the programmed connection
    matrices of all CMRouters in a domain."""

    def __init__(self, adj: np.ndarray):
        self.adj = adj
        self.dist = bfs_distances(adj)
        n = adj.shape[0]
        nh = np.full((n, n), -1, dtype=np.int32)
        for src in range(n):
            order = np.argsort(self.dist[src])
            for dst in order:
                if dst == src or self.dist[src, dst] < 0:
                    continue
                for nbr in np.nonzero(adj[src])[0]:
                    if self.dist[nbr, dst] == self.dist[src, dst] - 1:
                        nh[src, dst] = nbr
                        break
        self.next_hop = nh

    def path(self, src: int, dst: int) -> list[int]:
        p = [src]
        while p[-1] != dst:
            nxt = self.next_hop[p[-1], dst]
            assert nxt >= 0, f"no route {src}->{dst}"
            p.append(int(nxt))
        return p


@dataclasses.dataclass
class TrafficReport:
    spikes_delivered: int
    total_hops: int
    energy_pj: float
    cycles: float
    mode_counts: dict
    router_load: np.ndarray | None = None   # (n_nodes,) spike occupancy

    @property
    def avg_hops(self) -> float:
        return self.total_hops / max(self.spikes_delivered, 1)

    @property
    def pj_per_spike_hop(self) -> float:
        return self.energy_pj / max(self.total_hops, 1)

    @property
    def throughput_spike_per_cycle(self) -> float:
        return self.spikes_delivered / max(self.cycles, 1e-9)


@dataclasses.dataclass(frozen=True)
class FlowRoute:
    """One compiled flow: the static route a CMRouter connection matrix
    realizes for (src -> dsts), with per-spike hop/energy accounting
    precomputed so simulation is a cheap replay (no BFS at sim time).

    `hops` is charged per spike: path length for P2P; the size of the
    forked link union for broadcast.  `l2_hops` counts links incident to a
    level-2 router — the off-chip segment of a multi-domain route, priced
    separately by the energy model.
    """

    src: int
    dsts: tuple[int, ...]
    links: tuple[tuple[int, int], ...]   # directed (u, v) link set
    hops: int
    l2_hops: int
    mode: str                            # "p2p" | "broadcast"

    @property
    def l1_hops(self) -> int:
        return self.hops - self.l2_hops


def compile_flow(rt: RoutingTable, src: int, dsts: Sequence[int],
                 level2_nodes: frozenset[int] = frozenset()) -> FlowRoute:
    """Resolve one (src -> dsts) flow to its static route.

    Mode selection mirrors the CMRouter: 1 destination -> P2P; >1 ->
    broadcast (a single upstream traversal that forks at divergence
    points, i.e. the union of per-destination shortest paths).
    """
    if len(dsts) == 1:
        p = rt.path(src, int(dsts[0]))
        links = tuple(zip(p[:-1], p[1:]))
        mode = "p2p"
    else:
        link_set: set[tuple[int, int]] = set()
        for d in dsts:
            p = rt.path(src, int(d))
            link_set.update(zip(p[:-1], p[1:]))
        links = tuple(sorted(link_set))
        mode = "broadcast"
    l2 = sum(1 for u, v in links if u in level2_nodes or v in level2_nodes)
    return FlowRoute(src=src, dsts=tuple(int(d) for d in dsts), links=links,
                     hops=len(links), l2_hops=l2, mode=mode)


def replay_flows(
    routed: Sequence[tuple[FlowRoute, int]],
    params: RouterParams = RouterParams(),
    n_nodes: int = N_NODES,
    interconnect=None,
) -> TrafficReport:
    """Replay precompiled flows = [(route, n_spikes)] and account for them.

    Cycle model: each router moves at most `peak_throughput` spikes/cycle;
    the busiest router bounds the epoch's cycles (decentralized NoCs win by
    spreading load — exactly the paper's degree-variance argument).

    `interconnect` (an `energy.InterconnectEnergyModel`) prices level-2
    hops at the off-chip rate; without it all hops cost the on-chip rate.
    """
    router_load = np.zeros(n_nodes, dtype=np.int64)
    total_hops = 0
    energy = 0.0
    delivered = 0
    modes = {"p2p": 0, "broadcast": 0, "merge": 0}
    dst_seen: dict[int, int] = {}

    for route, n_spikes in routed:
        total_hops += route.hops * n_spikes
        for u, _v in route.links:
            router_load[u] += n_spikes
        if route.mode == "p2p":
            e_l1 = params.e_hop_p2p_pj
            modes["p2p"] += 1
            if route.dsts[0] in dst_seen:
                modes["merge"] += 1
            dst_seen[route.dsts[0]] = dst_seen.get(route.dsts[0], 0) + 1
        else:
            e_l1 = params.e_hop_bcast_pj
            modes["broadcast"] += 1
        if interconnect is None:
            energy += e_l1 * route.hops * n_spikes
        else:
            energy += interconnect.flow_pj(
                route.l1_hops, route.l2_hops, broadcast=route.mode != "p2p"
            ) * n_spikes
        delivered += n_spikes * len(route.dsts)

    cycles = float(router_load.max()) / params.peak_throughput if len(routed) else 0.0
    return TrafficReport(
        spikes_delivered=delivered,
        total_hops=total_hops,
        energy_pj=energy,
        cycles=cycles,
        mode_counts=modes,
        router_load=router_load,
    )


@dataclasses.dataclass(frozen=True)
class FlowTable:
    """Array lowering of a set of compiled `FlowRoute`s.

    Everything `replay_flows` derives per call is precomputed into flat
    numpy arrays indexed by flow, so a whole-timestep replay becomes a
    handful of multiply-adds — cheap on the host and, more importantly,
    usable from a traced XLA program.  The vectors are *per spike*:
    pricing a timestep with exact per-source-core fired counts is
    `fired @ hops` / `fired @ energy_pj` / `fired @ router_load` (see
    `replay_flows_exact`), which matches `replay_flows` on the same
    per-flow counts bit-for-bit in f64.  `src_core` records each flow's
    source core node id, aligning row `i` with the i-th core slice of
    the firing layer (the engines' per-layer slice tables preserve this
    order).
    """

    n_flows: int
    hops: np.ndarray           # (F,) int64 per-spike hops of each flow
    energy_pj: np.ndarray      # (F,) float64 per-spike energy of each flow
    router_load: np.ndarray    # (F, n_nodes) int64 per-spike router occupancy
    dst_fanout: np.ndarray     # (F,) int64 destinations per flow
    src_core: np.ndarray       # (F,) int64 source core node id per flow

    @property
    def hops_total(self) -> int:
        return int(self.hops.sum())

    @property
    def energy_total_pj(self) -> float:
        return float(self.energy_pj.sum())


def compile_flow_table(routes: Sequence[FlowRoute],
                       params: RouterParams = RouterParams(),
                       n_nodes: int = N_NODES,
                       interconnect=None) -> FlowTable:
    """Lower compiled flows to a `FlowTable` (the batch-friendly replay)."""
    f = len(routes)
    hops = np.zeros(f, np.int64)
    energy = np.zeros(f, np.float64)
    load = np.zeros((f, n_nodes), np.int64)
    fanout = np.zeros(f, np.int64)
    src = np.zeros(f, np.int64)
    for i, route in enumerate(routes):
        hops[i] = route.hops
        fanout[i] = len(route.dsts)
        src[i] = route.src
        for u, _v in route.links:
            load[i, u] += 1
        if interconnect is None:
            e_l1 = (params.e_hop_p2p_pj if route.mode == "p2p"
                    else params.e_hop_bcast_pj)
            energy[i] = e_l1 * route.hops
        else:
            energy[i] = interconnect.flow_pj(
                route.l1_hops, route.l2_hops, broadcast=route.mode != "p2p")
    return FlowTable(n_flows=f, hops=hops, energy_pj=energy,
                     router_load=load, dst_fanout=fanout, src_core=src)


def replay_flows_exact(table: FlowTable, fired):
    """Exact per-flow replay: `fired` holds each flow's spike count.

    `fired` is (..., F) — arbitrary leading axes (batch, time) broadcast
    through.  Returns float64 (hops, energy_pj, router_load) where
    `router_load` is (..., n_nodes) spike occupancy per router — the
    input to `contention_cycles`.  Agrees with `replay_flows` on the same
    [(route, n_spikes)] list to f64 rounding: two firing patterns with
    equal *total* spikes but different source cores price differently,
    which the old uniform-split heuristic could not express.
    """
    fired = np.asarray(fired, np.float64)
    hops = fired @ table.hops.astype(np.float64)
    energy = fired @ table.energy_pj
    load = fired @ table.router_load.astype(np.float64)
    return hops, energy, load


def contention_cycles(bottleneck_spikes, compute_cycles,
                      params: RouterParams = RouterParams()):
    """Router-contention cycles a timestep adds to the wall clock.

    `bottleneck_spikes` is the busiest router's spike occupancy for the
    step (max over `replay_flows_exact`'s router_load); it drains at the
    CMRouter's `peak_throughput` spikes/cycle, so the pure serialization
    cost is service = bottleneck / peak.  The spikes are offered while
    the cores compute (`compute_cycles`, the step's core critical path),
    giving a bottleneck utilization over the step interval of

        rho = service / (service + compute_cycles)

    and the M/M/1 waiting factor 1/(1-rho) — the same queueing model
    `latency_vs_injection` applies per hop — inflates the drain:

        contention = service / (1 - rho) = service + service^2 / window

    Light load (service << window) costs just the serialization; an
    overloaded bottleneck grows quadratically.  Decentralized topologies
    with even router load (the fullerene's low degree variance) stay in
    the light regime at injection rates that saturate a mesh or tree.
    Broadcasts with arbitrary leading axes; zero spikes cost zero cycles.
    """
    service = np.asarray(bottleneck_spikes, np.float64) / params.peak_throughput
    window = np.maximum(np.asarray(compute_cycles, np.float64), 1e-9)
    return service + service * service / window


def replay_flows_array(table: FlowTable, n_spikes,
                       params: RouterParams = RouterParams()):
    """Replay every flow of `table` with `n_spikes` spikes each.

    `n_spikes` may be a python int, a numpy array, or a traced jnp scalar
    (broadcast over flows) — the returns are then arrays of the same
    shape: (total_hops, energy_pj, cycles).  Agrees with `replay_flows`
    on uniform per-flow spike counts.
    """
    hops = table.hops_total * n_spikes
    energy = table.energy_total_pj * n_spikes
    peak = table.router_load.sum(axis=0).max() if table.n_flows else 0
    cycles = peak * n_spikes / params.peak_throughput
    return hops, energy, cycles


def simulate_traffic(
    adj: np.ndarray,
    flows: list[tuple[int, list[int], int]],
    params: RouterParams = RouterParams(),
) -> TrafficReport:
    """Route `flows` = [(src, [dsts], n_spikes)] over the NoC.

    Convenience wrapper: compiles each flow against a fresh routing table
    and replays it.  Hot paths (ChipSimulator, the compiler) should compile
    once with `compile_flow` and call `replay_flows` per timestep instead.
    """
    rt = RoutingTable(adj)
    routed = [(compile_flow(rt, src, dsts), n_spikes)
              for src, dsts, n_spikes in flows]
    return replay_flows(routed, params, n_nodes=adj.shape[0])


def uniform_random_flows(
    rng: np.random.Generator, n_flows: int, spikes_per_flow: int = 64,
    bcast_frac: float = 0.2, fanout: int = 3,
) -> list[tuple[int, list[int], int]]:
    """Synthetic core-to-core traffic over one level-1 domain."""
    cores = core_ids()
    flows = []
    for _ in range(n_flows):
        src = int(rng.choice(cores))
        if rng.random() < bcast_frac:
            dsts = list(rng.choice(cores[cores != src], size=fanout, replace=False))
        else:
            dsts = [int(rng.choice(cores[cores != src]))]
        flows.append((src, [int(d) for d in dsts], spikes_per_flow))
    return flows


# --------------------------------------------------------------------------
# Contention study: latency vs injection rate (the classic NoC curve)
# --------------------------------------------------------------------------

def uniform_pair_loads(rt: RoutingTable, endpoints: np.ndarray
                       ) -> tuple[np.ndarray, float]:
    """Expected per-router hop occupancy of one uniform-random spike over
    `endpoints` (all ordered pairs equally likely), plus the zero-load
    average hop count.  Shared by `latency_vs_injection` and
    `saturation_injection_rate`."""
    n = rt.adj.shape[0]
    ep = np.asarray(endpoints)
    loads = np.zeros(n)
    hops_total = 0
    n_pairs = 0
    for s in ep:
        for d in ep:
            if s == d:
                continue
            path = rt.path(int(s), int(d))
            for node in path[:-1]:
                loads[node] += 1
            hops_total += len(path) - 1
            n_pairs += 1
    loads /= n_pairs                      # per injected spike
    return loads, hops_total / n_pairs


def saturation_injection_rate(adj: np.ndarray, endpoints,
                              params: RouterParams = RouterParams()) -> float:
    """Per-endpoint injection rate (spikes/node/cycle) at which the
    bottleneck router of uniform-random traffic reaches rho = 1.

    From the `latency_vs_injection` model, rho = loads.max() * lam *
    n_endpoints / peak_throughput, so saturation onset is the closed form
    lam* = peak / (loads.max() * n_endpoints).  Decentralized topologies
    (even router load -> small loads.max()) sustain higher rates — the
    paper's degree-variance argument as a single number per topology.
    """
    rt = RoutingTable(adj)
    ep = np.asarray(endpoints)
    loads, _ = uniform_pair_loads(rt, ep)
    return float(params.peak_throughput / (loads.max() * len(ep)))


def latency_vs_injection(
    adj: np.ndarray,
    endpoints: np.ndarray,
    rates: Sequence[float] = (0.02, 0.05, 0.1, 0.2, 0.3, 0.38),
    params: RouterParams = RouterParams(),
) -> list[dict]:
    """Average spike latency under uniform-random traffic as the per-node
    injection rate rises (spikes/node/cycle).

    Queueing model: each hop's service rate is the router's peak
    throughput; with utilization rho on the bottleneck router, the mean
    per-hop wait scales as 1/(1-rho) (M/M/1).  Latency = zero-load hops *
    (1 + rho/(1-rho)).  Saturation appears as rho -> 1, and decentralized
    topologies (low degree variance -> even router load) saturate later —
    the paper's uniformity argument made quantitative.
    """
    rt = RoutingTable(adj)
    ep = np.asarray(endpoints)
    out = []
    loads, zero_load_hops = uniform_pair_loads(rt, ep)

    for lam in rates:
        # spikes injected per cycle across all endpoints
        inj = lam * len(ep)
        rho = float(loads.max()) * inj / params.peak_throughput
        if rho >= 1.0:
            out.append({"inject_rate": lam, "saturated": True,
                        "avg_latency_hops": float("inf"),
                        "bottleneck_rho": round(rho, 3)})
            continue
        latency = zero_load_hops * (1.0 + rho / (1.0 - rho))
        out.append({"inject_rate": lam, "saturated": False,
                    "avg_latency_hops": round(latency, 3),
                    "bottleneck_rho": round(rho, 3)})
    return out


def contention_comparison(rates=(0.02, 0.05, 0.1, 0.2, 0.3)) -> dict:
    """Fullerene vs 2D-mesh contention curves (endpoints = compute nodes)."""
    result = {}
    result["fullerene"] = latency_vs_injection(
        fullerene_adjacency(), core_ids(), rates)
    mesh = mesh_2d(4, 8)
    result["2d-mesh-4x8"] = latency_vs_injection(
        mesh, np.arange(32), rates)
    tr = tree(32, 2)
    result["binary-tree-32"] = latency_vs_injection(
        tr, np.arange(32), rates)
    return result
