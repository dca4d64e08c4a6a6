"""Hierarchical collective planner over interconnect topologies (C4).

Port of `repro.distributed.collectives`, over the port's `core/noc.py`
topologies.  Models the cost of the collectives a sharded step emits (all-reduce, all-gather,
reduce-scatter, broadcast/P2P) over different physical interconnects —
the paper's fullerene level-1 domain (+ level-2 scale-up) vs 2D mesh /
torus / tree — using the standard alpha-beta model on the topology graph:

    T(collective) = steps * alpha + bytes_on_busiest_link / link_bw

Ring algorithms dominate production all-reduce; on a general graph the
ring is an (approximate) Hamiltonian cycle and per-step traffic rides one
link per node, so effective bandwidth scales with min node degree and the
hierarchical variant (reduce-scatter intra-domain, all-reduce across
level-2, all-gather intra-domain) mirrors exactly how the multi-pod mesh
("pod" axis) schedules DP collectives.

This module quantifies the paper's qualitative claim — higher average
degree + lower degree variance => more link-parallel collective schedules
— and feeds the §Roofline collective-term narrative.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import noc as NOC


@dataclasses.dataclass(frozen=True)
class LinkParams:
    alpha_s: float = 1e-6          # per-step latency
    link_bw: float = 50e9          # B/s per link (the reference's ICI-class
                                   # figure, kept so the table is comparable)


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    name: str
    topology: str
    steps: int
    busiest_link_bytes: float
    seconds: float


def _ring_cost(n: int, bytes_per_node: float, parallel_rings: int,
               p: LinkParams, name: str, topo: str) -> CollectiveCost:
    """Ring all-reduce: 2(n-1) steps, each moving bytes/n per ring link;
    `parallel_rings` = edge-disjoint rings the topology can sustain
    (≈ floor(min_degree / 2))."""
    steps = 2 * (n - 1)
    per_link = bytes_per_node / n / max(parallel_rings, 1)
    secs = steps * p.alpha_s + steps * per_link / p.link_bw
    return CollectiveCost(name, topo, steps, per_link * steps, secs)


def topology_properties(adj: np.ndarray) -> dict:
    deg = adj.sum(axis=1)
    return {
        "n": int(adj.shape[0]),
        "min_degree": int(deg.min()),
        "avg_degree": float(deg.mean()),
        "parallel_rings": max(int(deg.min()) // 2, 1),
        "bisection_links": int(adj[: adj.shape[0] // 2, adj.shape[0] // 2:].sum()),
    }


def all_reduce_cost(adj: np.ndarray, bytes_per_node: float, topo_name: str,
                    p: LinkParams = LinkParams()) -> CollectiveCost:
    props = topology_properties(adj)
    return _ring_cost(props["n"], bytes_per_node, props["parallel_rings"],
                      p, "all-reduce", topo_name)


def broadcast_cost(adj: np.ndarray, bytes_total: float, topo_name: str,
                   p: LinkParams = LinkParams()) -> CollectiveCost:
    """Tree broadcast along BFS levels (the CMRouter broadcast mode)."""
    dist = NOC.bfs_distances(adj)
    depth = int(dist[0].max())
    secs = depth * p.alpha_s + depth * bytes_total / p.link_bw
    return CollectiveCost("broadcast", topo_name, depth, bytes_total * depth, secs)


def hierarchical_all_reduce(n_domains: int, domain_adj: np.ndarray,
                            bytes_per_node: float,
                            p: LinkParams = LinkParams()) -> dict:
    """Two-level schedule (level-1 domains + level-2 routers), exactly the
    multi-pod "pod"-axis pattern: RS intra-domain -> AR across level-2 ->
    AG intra-domain."""
    props = topology_properties(domain_adj)
    n = props["n"]
    intra_rs = _ring_cost(n, bytes_per_node, props["parallel_rings"], p,
                          "reduce-scatter", "fullerene-domain")
    # level-2: fully-connected router ring over n_domains, bytes/n per node
    l2 = _ring_cost(max(n_domains, 2), bytes_per_node / n, 1, p,
                    "all-reduce", "level-2")
    intra_ag = _ring_cost(n, bytes_per_node, props["parallel_rings"], p,
                          "all-gather", "fullerene-domain")
    total = intra_rs.seconds / 2 + l2.seconds + intra_ag.seconds / 2
    return {
        "intra_rs_s": intra_rs.seconds / 2,   # RS is half a ring AR
        "level2_ar_s": l2.seconds,
        "intra_ag_s": intra_ag.seconds / 2,
        "total_s": total,
    }


def comparison(bytes_per_node: float = 64 * 2**20) -> list[dict]:
    """All-reduce cost of one DP gradient bucket per topology (Fig. 5
    companion table for the collective roofline)."""
    rows = []
    for name, adj in [
        ("fullerene-32", NOC.fullerene_adjacency()),
        ("2d-mesh-4x8", NOC.mesh_2d(4, 8)),
        ("torus-4x8", NOC.mesh_2d(4, 8, torus=True)),
        ("binary-tree-32", NOC.tree(32, 2)),
        ("ring-32", NOC.ring(32)),
    ]:
        c = all_reduce_cost(adj, bytes_per_node, name)
        props = topology_properties(adj)
        rows.append({
            "topology": name,
            "min_degree": props["min_degree"],
            "parallel_rings": props["parallel_rings"],
            "all_reduce_ms": round(c.seconds * 1e3, 3),
        })
    return rows
