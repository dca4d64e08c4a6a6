"""Masked-graph survivability: what the fullerene topology buys you.

Port of `repro.faults.survivability` (numpy, on the port's `core/noc.py`).

The paper's decentralization argument (average degree +32% over
traditional topologies, degree variance 0.93) translates into multipath
fault tolerance: killing routers removes *vertices* of the icosahedron
whose *faces* (the cores) each touch three of them, so core-to-core
connectivity survives far more router kills than an equal-node mesh —
where every node is both endpoint and router, and a handful of kills
strands whole corners.

The study here quantifies that with two masked-graph metrics, averaged
over SeedSequence-seeded kill trials:

* **routable fraction** — ordered endpoint pairs that still have a
  path, over all pairs of the *original* endpoint set (a killed
  endpoint's pairs count as lost: in the mesh a router kill destroys
  that node's compute too, while fullerene router kills never touch a
  core — the decentralization dividend).
* **sustained injection rate** — the rho=1 saturation onset of uniform
  traffic over the *reachable* pairs (`noc.saturation_injection_rate`
  generalized to disconnected graphs), scaled by the fraction of pairs
  still routable so a partitioned topology cannot score well by serving
  only its largest island.

The reference's `benchmarks/fault_bench.py` gates the fullerene/mesh
ratio (> 1.0) as ``fault.survivability_ratio_vs_mesh``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import noc as NOC
from repro_torch.faults.model import FaultConfig, masked_adjacency, sample_faults


def routable_fraction(adj: np.ndarray, endpoints) -> float:
    """Fraction of ordered endpoint pairs with a surviving path."""
    ep = [int(e) for e in np.asarray(endpoints)]
    if len(ep) < 2:
        return 0.0
    dist = NOC.bfs_distances(np.asarray(adj))
    ok = total = 0
    for s in ep:
        for d in ep:
            if s == d:
                continue
            total += 1
            if dist[s, d] >= 0:
                ok += 1
    return ok / total


def masked_saturation_rate(adj: np.ndarray, endpoints,
                           params: NOC.RouterParams = NOC.RouterParams()
                           ) -> float:
    """`noc.saturation_injection_rate` tolerant to disconnection.

    Uniform traffic over the *reachable* ordered pairs only; the closed
    form lam* = peak / (loads.max() * n_injectors) — with injectors the
    endpoints that can still reach anything — is then scaled by the
    routable fraction over the full original pair set, so losing half
    the pairs halves the sustained rate even if the surviving island is
    uncongested.  Returns 0.0 when nothing routes.
    """
    ep = [int(e) for e in np.asarray(endpoints)]
    rt = NOC.RoutingTable(np.asarray(adj))
    loads = np.zeros(int(adj.shape[0]))
    injectors = set()
    n_pairs = total = 0
    for s in ep:
        for d in ep:
            if s == d:
                continue
            total += 1
            if rt.dist[s, d] < 0:
                continue
            for node in rt.path(s, d)[:-1]:
                loads[node] += 1
            injectors.add(s)
            n_pairs += 1
    if n_pairs == 0 or loads.max() <= 0:
        return 0.0
    loads /= n_pairs
    lam = float(params.peak_throughput / (loads.max() * len(injectors)))
    return lam * (n_pairs / total)


def _fullerene_trial(k: int, seed: int, trial: int,
                     params: NOC.RouterParams) -> tuple[float, float]:
    """Kill k of the 12 level-1 routers; endpoints are the 20 cores.

    The graph includes the level-2 router (as the chip does), so the
    surviving level-1 routers never partition from each other — a core
    is stranded only when all three of its routers die.
    """
    adj = NOC.fullerene_adjacency(with_level2=True)
    faults = sample_faults(seed, routers=NOC.router_ids(),
                           cores=NOC.core_ids(), router_kills=k, trial=trial)
    masked = masked_adjacency(adj, faults)
    eps = NOC.core_ids()
    return routable_fraction(masked, eps), masked_saturation_rate(
        masked, eps, params)


def _mesh_trial(k: int, seed: int, trial: int,
                params: NOC.RouterParams) -> tuple[float, float]:
    """Kill k nodes of the equal-node 4x8 mesh (32 nodes, like one
    fullerene domain).  Mesh nodes route AND compute, so a router kill
    removes an endpoint too; metrics run over the original endpoint set
    and a dead endpoint's pairs count as lost."""
    adj = NOC.mesh_2d(4, 8)
    nodes = np.arange(adj.shape[0])
    faults = sample_faults(seed, routers=nodes, cores=(),
                           router_kills=k, trial=trial)
    masked = masked_adjacency(adj, faults)
    return (routable_fraction(masked, nodes),
            masked_saturation_rate(masked, nodes, params))


def survivability_study(k: int = 4, trials: int = 16, seed: int = 0,
                        params: NOC.RouterParams = NOC.RouterParams()
                        ) -> dict:
    """Fullerene vs equal-node mesh under k random router kills.

    Deterministic: every trial's kill set comes from
    SeedSequence([seed, salt, trial]).  The headline ratio compares mean
    routable fractions; the saturation ratio compares mean sustained
    injection rates (both > 1.0 == fullerene survives better).
    """
    f_frac, f_sat, m_frac, m_sat = [], [], [], []
    for t in range(int(trials)):
        fr, fs = _fullerene_trial(k, seed, t, params)
        mr, ms = _mesh_trial(k, seed, t, params)
        f_frac.append(fr)
        f_sat.append(fs)
        m_frac.append(mr)
        m_sat.append(ms)
    f_frac_m, m_frac_m = float(np.mean(f_frac)), float(np.mean(m_frac))
    f_sat_m, m_sat_m = float(np.mean(f_sat)), float(np.mean(m_sat))
    return {
        "router_kills": int(k),
        "trials": int(trials),
        "fullerene": {"routable_frac": f_frac_m, "saturation_rate": f_sat_m,
                      "partitioned_trials": int(sum(f < 1.0 for f in f_frac))},
        "mesh": {"routable_frac": m_frac_m, "saturation_rate": m_sat_m,
                 "partitioned_trials": int(sum(f < 1.0 for f in m_frac))},
        "routable_ratio_vs_mesh": f_frac_m / max(m_frac_m, 1e-12),
        "saturation_ratio_vs_mesh": f_sat_m / max(m_sat_m, 1e-12),
    }
