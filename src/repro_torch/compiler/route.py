"""Stage 3 — route: emit static per-CMRouter connection-matrix tables.

For every inter-layer flow (all spikes a source core emits fan out to the
cores holding the next layer) we resolve the shortest-path route once, at
compile time, into:

  * a `noc.FlowRoute` — the per-flow link set + hop/level-2 accounting the
    simulator replays each timestep (no BFS at sim time), and
  * `RouterTables` — the programmed connection matrices: for each CMRouter
    node, entries (in_node, dst_core) -> out_nodes.  Broadcast flows fork
    (multiple out_nodes); merges show up as several in_nodes sharing one
    (dst_core) column.  `follow` walks the tables and must reproduce the
    BFS path — the round-trip property the tests pin down.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.compiler.partition import CoreGroup
from repro_torch.core import noc as NOC


@dataclasses.dataclass
class RouterTables:
    """Connection matrices for every routing node in the (multi-domain)
    graph: node -> {(in_node, dst_core): (out_node, ...)}.

    `in_node` == the node itself marks a locally injected spike (the entry
    a core writes into its attached router's input port).
    """

    tables: dict[int, dict[tuple[int, int], tuple[int, ...]]]

    def n_entries(self) -> int:
        return sum(len(t) for t in self.tables.values())

    def add(self, node: int, in_node: int, dst: int, out_node: int) -> None:
        tab = self.tables.setdefault(node, {})
        key = (in_node, dst)
        outs = set(tab.get(key, ()))
        outs.add(out_node)
        tab[key] = tuple(sorted(outs))

    def follow(self, src: int, dst: int, max_hops: int = 64) -> list[int]:
        """Walk the programmed tables from `src` toward `dst`.  Follows the
        unique next hop per (in_node, dst) entry; raises if the tables do
        not deliver."""
        path = [src]
        prev = src
        while path[-1] != dst:
            if len(path) > max_hops:
                raise ValueError(f"route {src}->{dst} does not converge")
            node = path[-1]
            key = (prev if len(path) > 1 else node, dst)
            outs = self.tables.get(node, {}).get(key)
            if outs is None:
                raise KeyError(f"no table entry at node {node} for {key}")
            # a fork lists several out_nodes; follow the one that still
            # leads to dst (broadcast branches are verified per-destination)
            nxt = outs[0] if len(outs) == 1 else None
            if nxt is None:
                for o in outs:
                    if self._leads_to(o, node, dst, max_hops - len(path)):
                        nxt = o
                        break
            if nxt is None:
                raise ValueError(f"dead fork at node {node} for dst {dst}")
            prev = node
            path.append(int(nxt))
        return path

    def _leads_to(self, node: int, came_from: int, dst: int, budget: int) -> bool:
        if node == dst:
            return True
        if budget <= 0:
            return False
        outs = self.tables.get(node, {}).get((came_from, dst), ())
        return any(self._leads_to(int(o), node, dst, budget - 1) for o in outs)


@dataclasses.dataclass
class RoutedNetwork:
    """The route stage's output, consumed by soc.ChipSimulator.

    `routing` is None for hierarchically routed networks — their paths
    are composed from one shared 33-node local table, so the global BFS
    table was never needed; `routing_table()` builds it on demand (only
    verification wants it).
    """

    adjacency: np.ndarray
    routing: NOC.RoutingTable | None
    # src layer index -> one FlowRoute per source core of that layer
    layer_flows: dict[int, list[NOC.FlowRoute]]
    router_tables: RouterTables
    level2_nodes: frozenset[int]

    def routing_table(self) -> NOC.RoutingTable:
        if self.routing is None:
            self.routing = NOC.RoutingTable(self.adjacency)
        return self.routing

    def flows_of_layer(self, layer: int) -> list[NOC.FlowRoute]:
        return self.layer_flows.get(layer, [])

    def total_l2_hops(self) -> int:
        return sum(f.l2_hops for fl in self.layer_flows.values() for f in fl)


def route(groups: list[CoreGroup], assignment: dict[int, int],
          adj: np.ndarray, level2_nodes: frozenset[int]) -> RoutedNetwork:
    """Resolve every layer-to-layer flow and program the router tables."""
    rt = NOC.RoutingTable(adj)
    by_layer: dict[int, list[CoreGroup]] = {}
    for g in groups:
        by_layer.setdefault(g.layer, []).append(g)
    tables = RouterTables(tables={})
    layer_flows: dict[int, list[NOC.FlowRoute]] = {}

    last = max(by_layer)
    for layer, srcs in sorted(by_layer.items()):
        if layer == last:
            continue
        dst_cores = sorted({assignment[g.gid] for g in by_layer[layer + 1]})
        flows = []
        for g in srcs:
            src_core = assignment[g.gid]
            fr = NOC.compile_flow(rt, src_core, dst_cores, level2_nodes)
            flows.append(fr)
            _program_tables(tables, rt, src_core, dst_cores)
        layer_flows[layer] = flows
    return RoutedNetwork(adjacency=adj, routing=rt, layer_flows=layer_flows,
                         router_tables=tables, level2_nodes=level2_nodes)


def _program_tables(tables: RouterTables, rt: NOC.RoutingTable,
                    src: int, dsts: list[int]) -> None:
    for dst in dsts:
        if dst == src:
            continue
        path = rt.path(src, dst)
        prev = src
        for u, v in zip(path[:-1], path[1:]):
            tables.add(u, prev, dst, v)
            prev = u


# ---------------------------------------------------------------------------
# hierarchical routing: intra-domain and inter-chip level-2 flows separately
# ---------------------------------------------------------------------------
#
# Domains are only connected through their level-2 routers, so a global
# shortest path either stays inside one domain (it cannot leave and
# re-enter without visiting that domain's level-2 node twice) or is
# exactly  local(src -> L2_a) + (L2_a -> L2_b) + local(L2_b -> dst).
# The global BFS next-hop rule (`np.nonzero` ascending-id tie-break)
# never routes through a *foreign* level-2 node for either piece, so
# paths composed from ONE shared 33-node local table are link-for-link
# identical to the flat `RoutingTable` paths — `route_hierarchical`
# emits the same FlowRoutes as `route` without the O(n^2) global BFS.

def _composed_path(lrt: NOC.RoutingTable, src: int, dst: int) -> list[int]:
    """Global path from local-table pieces (see module comment)."""
    stride = NOC.DOMAIN_STRIDE
    ds, dd = src // stride, dst // stride
    if ds == dd:
        return [ds * stride + n for n in lrt.path(src % stride, dst % stride)]
    up = lrt.path(src % stride, NOC.N_NODES)
    down = lrt.path(NOC.N_NODES, dst % stride)
    return ([ds * stride + n for n in up]
            + [dd * stride + n for n in down])


def _compose_flow(lrt: NOC.RoutingTable, src: int, dsts: list[int],
                  level2_nodes: frozenset[int]) -> NOC.FlowRoute:
    """`noc.compile_flow` semantics over composed paths."""
    if len(dsts) == 1:
        p = _composed_path(lrt, src, int(dsts[0]))
        links = tuple(zip(p[:-1], p[1:]))
        mode = "p2p"
    else:
        link_set: set[tuple[int, int]] = set()
        for d in dsts:
            p = _composed_path(lrt, src, int(d))
            link_set.update(zip(p[:-1], p[1:]))
        links = tuple(sorted(link_set))
        mode = "broadcast"
    l2 = sum(1 for u, v in links if u in level2_nodes or v in level2_nodes)
    return NOC.FlowRoute(src=src, dsts=tuple(int(d) for d in dsts),
                         links=links, hops=len(links), l2_hops=l2, mode=mode)


def route_hierarchical(groups: list[CoreGroup], assignment: dict[int, int],
                       adj: np.ndarray, level2_nodes: frozenset[int]
                       ) -> RoutedNetwork:
    """Resolve every flow from one shared local routing table: local
    paths for the intra-domain segments, the direct L2 -> L2 edge for the
    inter-chip crossing.  Emits FlowRoutes and RouterTables identical to
    the flat `route` (tests pin this down) at O(domain) instead of
    O(fabric) table-build cost."""
    lrt = NOC.RoutingTable(NOC.fullerene_adjacency(with_level2=True))
    by_layer: dict[int, list[CoreGroup]] = {}
    for g in groups:
        by_layer.setdefault(g.layer, []).append(g)
    tables = RouterTables(tables={})
    layer_flows: dict[int, list[NOC.FlowRoute]] = {}

    last = max(by_layer)
    for layer, srcs in sorted(by_layer.items()):
        if layer == last:
            continue
        dst_cores = sorted({assignment[g.gid] for g in by_layer[layer + 1]})
        flows = []
        for g in srcs:
            src_core = assignment[g.gid]
            flows.append(_compose_flow(lrt, src_core, dst_cores,
                                       level2_nodes))
            for dst in dst_cores:
                if dst == src_core:
                    continue
                path = _composed_path(lrt, src_core, dst)
                prev = src_core
                for u, v in zip(path[:-1], path[1:]):
                    tables.add(u, prev, dst, v)
                    prev = u
        layer_flows[layer] = flows
    return RoutedNetwork(adjacency=adj, routing=None,
                         layer_flows=layer_flows, router_tables=tables,
                         level2_nodes=level2_nodes)


def verify_roundtrip(routed: RoutedNetwork) -> None:
    """Every programmed (src, dst) pair must be deliverable by table-walk
    with exactly the BFS shortest-path hop count.  Raises on any miss."""
    dist = routed.routing_table().dist
    for layer, flows in routed.layer_flows.items():
        for fr in flows:
            for dst in fr.dsts:
                if dst == fr.src:
                    continue
                path = routed.router_tables.follow(fr.src, dst)
                if len(path) - 1 != int(dist[fr.src, dst]):
                    raise AssertionError(
                        f"table walk {fr.src}->{dst} took {len(path) - 1} hops,"
                        f" BFS distance is {int(dist[fr.src, dst])}")
