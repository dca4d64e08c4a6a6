"""Stage 4 — scale-up: span multiple level-1 domains via level-2 routers.

A network whose partition needs more than one domain's 20 cores is spread
over ceil(n_groups / 20) fullerene domains.  Each domain keeps its own
level-2 router ("center point of the topology"); level-2 routers form the
fully connected off-chip high-level interconnect.  Placement then runs on
the multi-domain graph with level-2 links priced at the off-chip premium,
so the annealer packs chatty layers into one domain and only crosses
domains where the partition forces it.

`domain_energy_summary` prices a routed network's traffic through
`energy.InterconnectEnergyModel`, splitting on-chip vs off-chip picojoules
— the number the scale-up acceptance check reads.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.compiler.ir import ChipSpec, NetworkGraph
from repro_torch.compiler.partition import CoreGroup
from repro_torch.compiler.route import RoutedNetwork
from repro_torch.core import noc as NOC


@dataclasses.dataclass(frozen=True)
class ScaleUpPlan:
    n_domains: int
    adjacency: np.ndarray
    core_slots: np.ndarray            # global node ids placement may use
    level2_nodes: frozenset[int]

    @property
    def multi_domain(self) -> bool:
        return self.n_domains > 1


def plan(groups: list[CoreGroup], spec: ChipSpec) -> ScaleUpPlan:
    """Pick the domain count and build the routing graph placement uses."""
    n_domains = spec.domains_needed(len(groups))
    if n_domains > spec.max_domains:
        raise ValueError(
            f"network needs {n_domains} domains but ChipSpec allows "
            f"{spec.max_domains}")
    if n_domains == 1:
        # single-domain chips route without a level-2 hop at all
        return ScaleUpPlan(
            n_domains=1,
            adjacency=NOC.fullerene_adjacency(),
            core_slots=NOC.core_ids(),
            level2_nodes=frozenset())
    return ScaleUpPlan(
        n_domains=n_domains,
        adjacency=NOC.multi_domain_adjacency(n_domains),
        core_slots=NOC.multi_domain_core_ids(n_domains),
        level2_nodes=frozenset(int(x) for x in NOC.level2_node_ids(n_domains)))


def domain_of(node: int) -> int:
    """Which level-1 domain a global node id belongs to."""
    return node // NOC.DOMAIN_STRIDE


def domains_used(assignment: dict[int, int], plan_: ScaleUpPlan) -> int:
    if not plan_.multi_domain:
        return 1
    return len({domain_of(c) for c in assignment.values()})


def domain_energy_summary(net: NetworkGraph, routed: RoutedNetwork,
                          spec: ChipSpec) -> dict:
    """Per-timestep NoC energy split into level-1 vs level-2 picojoules,
    using the compiled routes and the layer spike rates."""
    ic = spec.interconnect
    l1_pj = l2_pj = 0.0
    l1_hops = l2_hops = 0.0
    for layer, flows in routed.layer_flows.items():
        rate = net.spike_rates[layer]
        per_src = rate / max(len(flows), 1)
        for fr in flows:
            bcast = fr.mode != "p2p"
            e_l1 = (ic.e_hop_l1_bcast_pj if bcast else ic.e_hop_l1_p2p_pj)
            l1_pj += e_l1 * fr.l1_hops * per_src
            l2_pj += ic.e_hop_l2_pj * fr.l2_hops * per_src
            l1_hops += fr.l1_hops * per_src
            l2_hops += fr.l2_hops * per_src
    return {
        "l1_hops_per_step": l1_hops,
        "l2_hops_per_step": l2_hops,
        "l1_pj_per_step": l1_pj,
        "l2_pj_per_step": l2_pj,
        "noc_pj_per_step": l1_pj + l2_pj,
        "level2_premium": ic.level2_premium(),
    }
