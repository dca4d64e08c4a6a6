"""The fault model of the port: what can break on the chip, as a value.

Port of `repro.faults.model`.  `FaultConfig` is a frozen dataclass;
nothing about it executes.  The lowering helpers below fold a config into
`ChipSimulator` state exactly once, at construction:

* **dead cores** — the core's neuron slices never integrate or fire:
  their weight *columns* are zeroed, so membrane potential stays at rest
  and the ZSPE/partial-update counters (and therefore energy/cycles)
  drop out with them.  Both array engines see the same static mask
  through `sim.weights`.
* **failed routers / links** — the chip's CMRouter tables were programmed
  on the healthy graph, so a packet whose static route crosses a failed
  node or link is lost in transit: the (src core, dst core) weight
  *block* of the affected transition is zeroed.  Source cores still fire
  (and the NoC replay still prices the flow — the energy is committed
  before the packet dies), but the destination never integrates.  With
  ``rerouted=True`` (a repaired chip — see `compiler.repair`) routes are
  instead recompiled on the fault-masked adjacency and nothing is
  blocked; unreachable pairs raise.
* **codebook corruption** — stuck-at / bit-flip faults on a core's
  `RegisterTable` codebook words (SEU model).  The corrupted table is
  re-validated (words stay in the signed W-bit range) and the core's
  weight slice is re-dequantized through it, so the executed weights are
  exactly what the corrupted registers encode.
* **per-hop packet drop** — each inter-core spike survives one hop with
  probability ``1 - drop_p``; a neuron's packets travel its source
  core's compiled flow, so its per-timestep survival probability is
  ``(1 - drop_p) ** hops``.  The Bernoulli draws are the reference's
  `jax.random` draws, bit for bit (`faults/_threefry.py`): a key derived
  from the config seed and folded with (layer, timestep).  Draws are
  shared across the batch (the fault process belongs to the chip, not
  the sample).
* **transient dispatch faults** — `transient_dispatches` lists dispatch
  indices at which the chip raises `TransientChipFault` after the run
  but before results are read back (a mid-flight loss, the retryable
  failure a server recovers from).

Zero-cost off: `NULL_FAULTS` (the default) short-circuits every helper,
so a fault-free simulator takes the exact pre-existing code path and the
engines issue the same torch ops (tests/test_torch_faults.py counts them).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.faults import _threefry as TF


class TransientChipFault(RuntimeError):
    """A retryable dispatch failure: the run happened but the result was
    lost (packet storm, host-link hiccup, injected test fault).  A server
    retries these with backoff; anything else stays fatal."""


# fixed salts so each fault class draws an independent SeedSequence stream
_SALT_DEAD, _SALT_ROUTER, _SALT_LINK, _SALT_DROP, _SALT_WORD = 1, 2, 3, 4, 5


def derive_fault_seed(seed: int, salt: int) -> int:
    """Stable derived seed (the PR-8 `derive_domain_seed` convention):
    independent streams per fault class, no global RNG involved."""
    return int(np.random.SeedSequence([int(seed), int(salt)])
               .generate_state(1)[0])


@dataclasses.dataclass(frozen=True)
class CodebookFault:
    """One corrupted codebook word of one core's RegisterTable.

    ``kind="bitflip"`` XORs bit `bit` of the word's W-bit two's-complement
    pattern (an SEU); ``kind="stuck"`` forces the word to `value`.  Either
    way the result must stay in the signed W-bit range — the corrupted
    table re-runs `RegisterTable.__post_init__` validation.
    """

    core_id: int
    word: int                      # codebook word index, 0 <= word < N
    kind: str = "bitflip"          # "bitflip" | "stuck"
    bit: int = 0                   # for bitflip: bit position, 0 <= bit < W
    value: int = 0                 # for stuck: the forced word value

    def __post_init__(self):
        if self.kind not in ("bitflip", "stuck"):
            raise ValueError(f"codebook fault kind {self.kind!r} "
                             "(want 'bitflip' or 'stuck')")

    def apply(self, word: int, bits: int) -> int:
        """The corrupted word value (signed, W-bit)."""
        if self.kind == "stuck":
            return int(self.value)
        mask = (1 << bits) - 1
        flipped = (int(word) & mask) ^ (1 << int(self.bit))
        if flipped >= 1 << (bits - 1):         # reinterpret as signed
            flipped -= 1 << bits
        return flipped


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """A faulty chip, as a value.  All fields default to 'nothing broken'."""

    dead_cores: tuple[int, ...] = ()
    failed_routers: tuple[int, ...] = ()            # level-1 or level-2 nodes
    failed_links: tuple[tuple[int, int], ...] = ()  # undirected (u, v)
    codebook_faults: tuple[CodebookFault, ...] = ()
    drop_p: float = 0.0                             # per-hop packet loss
    transient_dispatches: tuple[int, ...] = ()      # failing dispatch indices
    seed: int = 0
    # True on a repaired chip: CMRouter tables were reprogrammed on the
    # fault-masked graph (compiler.repair), so nothing is blocked and the
    # simulator routes (and prices) the detours instead
    rerouted: bool = False

    def __post_init__(self):
        object.__setattr__(self, "dead_cores",
                           tuple(sorted({int(c) for c in self.dead_cores})))
        object.__setattr__(self, "failed_routers",
                           tuple(sorted({int(r)
                                         for r in self.failed_routers})))
        links = {tuple(sorted((int(u), int(v))))
                 for u, v in self.failed_links}
        object.__setattr__(self, "failed_links", tuple(sorted(links)))
        object.__setattr__(self, "codebook_faults",
                           tuple(self.codebook_faults))
        object.__setattr__(self, "transient_dispatches",
                           tuple(sorted({int(i)
                                         for i in self.transient_dispatches})))
        if not 0.0 <= float(self.drop_p) < 1.0:
            raise ValueError(f"drop_p must be in [0, 1), got {self.drop_p}")

    # -- predicates ---------------------------------------------------------

    def is_null(self) -> bool:
        """True when nothing is broken — the config must then be free."""
        return not (self.dead_cores or self.failed_routers
                    or self.failed_links or self.codebook_faults
                    or self.drop_p or self.transient_dispatches)

    def topology_faults(self) -> bool:
        return bool(self.dead_cores or self.failed_routers
                    or self.failed_links)

    def blocked_nodes(self) -> frozenset[int]:
        """Nodes no packet may transit: failed routers AND dead cores
        (the bipartite fullerene graph routes core->router->core->..., so
        a dead core also stops being a through-hop)."""
        return frozenset(self.dead_cores) | frozenset(self.failed_routers)

    def with_rerouted(self) -> "FaultConfig":
        """The same physical faults on a repaired (reprogrammed) chip."""
        return dataclasses.replace(self, rerouted=True)

    def describe(self) -> dict:
        return {
            "dead_cores": list(self.dead_cores),
            "failed_routers": list(self.failed_routers),
            "failed_links": [list(l) for l in self.failed_links],
            "codebook_faults": len(self.codebook_faults),
            "drop_p": float(self.drop_p),
            "transient_dispatches": list(self.transient_dispatches),
            "seed": int(self.seed),
            "rerouted": bool(self.rerouted),
        }


NULL_FAULTS = FaultConfig()


def sample_faults(seed: int, *, routers, cores,
                  router_kills: int = 0, core_kills: int = 0,
                  link_kills: int = 0, adj: np.ndarray | None = None,
                  drop_p: float = 0.0, trial: int = 0) -> FaultConfig:
    """Draw a random FaultConfig from SeedSequence streams.

    `routers` / `cores` are the candidate node-id pools (e.g.
    `NOC.router_ids()` / `NOC.core_ids()`); `adj` supplies the link pool
    when `link_kills > 0`.  `trial` indexes independent draws of the same
    severity (survivability studies average over trials).
    """
    def pick(pool, k, salt):
        pool = np.asarray(list(pool))
        if k <= 0 or not len(pool):
            return ()
        rng = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence([int(seed), int(salt), int(trial)])))
        k = min(int(k), len(pool))
        return tuple(int(x) for x in rng.choice(pool, size=k, replace=False))

    failed_links: tuple = ()
    if link_kills > 0:
        if adj is None:
            raise ValueError("link_kills needs the adjacency matrix")
        iu, iv = np.nonzero(np.triu(np.asarray(adj), 1))
        edges = list(zip(iu.tolist(), iv.tolist()))
        idx = pick(range(len(edges)), link_kills, _SALT_LINK)
        failed_links = tuple(edges[i] for i in idx)
    return FaultConfig(
        dead_cores=pick(cores, core_kills, _SALT_DEAD),
        failed_routers=pick(routers, router_kills, _SALT_ROUTER),
        failed_links=failed_links,
        drop_p=drop_p,
        seed=derive_fault_seed(seed, trial))


# ---------------------------------------------------------------------------
# graph lowering
# ---------------------------------------------------------------------------

def masked_adjacency(adj: np.ndarray, faults: FaultConfig) -> np.ndarray:
    """The surviving graph: failed routers and dead cores lose every
    edge, failed links lose theirs (both directions).  Shape is kept —
    node ids stay stable for routing tables and placement slots."""
    out = np.array(adj, copy=True)
    n = out.shape[0]
    for node in faults.blocked_nodes():
        if not 0 <= int(node) < n:
            raise ValueError(f"fault node {node} outside graph of {n} nodes")
        out[int(node), :] = 0
        out[:, int(node)] = 0
    for u, v in faults.failed_links:
        if not (0 <= int(u) < n and 0 <= int(v) < n):
            raise ValueError(f"fault link ({u}, {v}) outside graph "
                             f"of {n} nodes")
        out[int(u), int(v)] = 0
        out[int(v), int(u)] = 0
    return out


def _path_blocked(rt, src: int, dst: int, blocked: frozenset[int],
                  bad_links: frozenset[tuple[int, int]]) -> bool:
    """Does the healthy-graph static route src->dst cross a failure?"""
    path = rt.path(int(src), int(dst))
    for node in path[1:-1]:
        if node in blocked:
            return True
    for u, v in zip(path, path[1:]):
        if tuple(sorted((u, v))) in bad_links:
            return True
    return False


# ---------------------------------------------------------------------------
# chip lowering (called once from ChipSimulator.__init__)
# ---------------------------------------------------------------------------

def corrupt_register_tables(sim) -> None:
    """Apply `codebook_faults` to `sim.register_tables` and re-dequantize
    the affected cores' weight slices through the corrupted tables.

    Requires table-exact weights (every weight column value appears in
    its core's codebook — true for any quantized simulator); raises
    ValueError otherwise, because corrupting a table the weights were
    never read from would be a silent no-op.  The exactness check runs in
    numpy on a host copy of the slice; the corrupted values are written
    into the weights on the simulator's device.
    """
    by_core: dict[int, list[CodebookFault]] = {}
    for cf in sim.faults.codebook_faults:
        by_core.setdefault(int(cf.core_id), []).append(cf)
    if not by_core:
        return
    hit_cores = set()
    for ti, (a, rt) in enumerate(zip(sim.mapping.assignments,
                                     sim.register_tables)):
        flts = by_core.get(int(a.core_id))
        if not flts:
            continue
        hit_cores.add(int(a.core_id))
        if not rt.codebook_words:
            raise ValueError(
                f"core {a.core_id}: codebook fault on an unprogrammed "
                "RegisterTable — codebook faults need a quantized simulator")
        words = list(rt.codebook_words)
        for cf in flts:
            if not 0 <= int(cf.word) < len(words):
                raise ValueError(
                    f"core {a.core_id}: codebook word {cf.word} outside "
                    f"N={len(words)} table")
            words[int(cf.word)] = cf.apply(words[int(cf.word)],
                                           rt.weight_bits)
        # re-validates the signed W-bit range via __post_init__
        corrupted = dataclasses.replace(rt, codebook_words=tuple(words))
        sim.register_tables[ti] = corrupted
        cb_old = rt.codebook()
        cb_new = corrupted.codebook()
        w = sim.weights[a.layer - 1]
        cols = w[:, a.neuron_lo:a.neuron_hi].cpu().numpy()
        idx = np.argmin(np.abs(cols[..., None] - cb_old[None, None, :]),
                        axis=-1)
        if not np.array_equal(cb_old[idx], cols):
            raise ValueError(
                f"core {a.core_id}: weights are not table-exact — cannot "
                "re-dequantize through the corrupted codebook")
        w = w.clone()
        w[:, a.neuron_lo:a.neuron_hi] = torch.as_tensor(cb_new[idx],
                                                        device=w.device)
        sim.weights[a.layer - 1] = w
    missing = set(by_core) - hit_cores
    if missing:
        raise ValueError(f"codebook faults target unmapped cores "
                         f"{sorted(missing)}")


def apply_chip_faults(sim) -> None:
    """Fold the simulator's FaultConfig into its weights + tables.

    Called once from `ChipSimulator.__init__`, after quantization and
    register-table construction and before `nonzero_weights` (so the
    partial-update touch masks see the faulted synapses).  Mutates
    `sim.weights` / `sim.register_tables` in place; a null config
    returns immediately without touching anything.
    """
    faults: FaultConfig = sim.faults
    if faults.is_null():
        return
    n_nodes = int(sim.adj.shape[0])
    for node in (*faults.dead_cores, *faults.failed_routers):
        if not 0 <= int(node) < n_nodes:
            raise ValueError(
                f"fault node {node} outside the chip's {n_nodes}-node fabric")
    corrupt_register_tables(sim)

    dead = frozenset(faults.dead_cores)
    if dead:
        # a dead core's neurons never integrate: zero their weight
        # columns (membrane stays at rest, nothing fires, ZSPE skips it)
        for a in sim.mapping.assignments:
            if int(a.core_id) in dead:
                w = sim.weights[a.layer - 1].clone()
                w[:, a.neuron_lo:a.neuron_hi] = 0.0
                sim.weights[a.layer - 1] = w

    if ((faults.failed_routers or faults.failed_links or dead)
            and not faults.rerouted):
        # unrepaired chip: static routes were programmed on the healthy
        # graph, so flows crossing a failure deliver nothing — zero the
        # (src core, dst core) weight block of every blocked pair
        blocked = faults.blocked_nodes()
        bad_links = frozenset(faults.failed_links)
        for li in range(1, len(sim.weights)):
            srcs = sim.mapping.cores_of_layer(li)
            dsts = sim.mapping.cores_of_layer(li + 1)
            w = None
            for s in srcs:
                if int(s.core_id) in dead:
                    continue               # already fully zeroed
                for d in dsts:
                    if s.core_id == d.core_id:
                        continue           # on-core delivery, no NoC hop
                    if _path_blocked(sim.routing, s.core_id, d.core_id,
                                     blocked, bad_links):
                        if w is None:
                            w = sim.weights[li].clone()
                        w[s.neuron_lo:s.neuron_hi,
                          d.neuron_lo:d.neuron_hi] = 0.0
            if w is not None:
                sim.weights[li] = w


# ---------------------------------------------------------------------------
# per-hop drop plan (the only dynamic fault — seeded, replayed everywhere)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DropPlan:
    """Seeded per-timestep spike-survival masks, one plan per simulator.

    ``keep_p[li]`` is the per-neuron survival probability for the output
    spikes of weight layer ``li`` in transit to layer ``li+2`` (None when
    that transition never crosses the NoC — notably the output layer).
    The mask for (layer, timestep) is the reference's Bernoulli draw from
    ``fold_in(fold_in(PRNGKey(key_seed), li), t)``, bit for bit.  `mask()`
    is the eager form; `masks()` draws a layer's masks for every timestep
    of a run in one call, which the engines take once per run.
    """

    key_seed: int
    keep_p: tuple                 # per layer: np.float32 (n_post,) or None

    def layer_key(self, li: int, device=None):
        """`fold_in(PRNGKey(key_seed), li)`; on the card unless `device`
        says otherwise."""
        return TF.fold_in(TF.prng_key(self.key_seed, resolve_device(device)),
                          li)

    def _draw(self, li: int, steps: torch.Tensor) -> torch.Tensor:
        k0, k1 = TF.fold_in(self.layer_key(li, steps.device), steps)
        p = torch.as_tensor(self.keep_p[li], device=steps.device)
        return TF.bernoulli((k0[:, None], k1[:, None]), p).to(torch.float32)

    def mask(self, li: int, t: int, device=None) -> torch.Tensor:
        """(n_post,) f32 0/1: the surviving spikes of layer li at step t,
        on the card unless `device` says otherwise."""
        return self._draw(
            li, torch.tensor([int(t)], device=resolve_device(device)))[0]

    def masks(self, li: int, steps: int, device=None) -> torch.Tensor:
        """(steps, n_post) f32 0/1: `mask(li, t)` for t in range(steps)."""
        return self._draw(
            li, torch.arange(int(steps), device=resolve_device(device)))


def build_drop_plan(sim) -> DropPlan | None:
    """Lower `drop_p` against the simulator's compiled flows.

    A spike from neuron j of layer li+1 travels its source core's
    FlowRoute; surviving `hops` hops i.i.d. gives keep probability
    ``(1 - drop_p) ** hops``.  Returns None when `drop_p == 0` or no
    transition crosses the NoC — the engines then lower the exact
    fault-free program (zero-cost off).
    """
    faults: FaultConfig = sim.faults
    p = float(faults.drop_p)
    if p <= 0.0:
        return None
    L = len(sim.weights)
    keep_p: list = [None] * L
    any_active = False
    for li in range(L - 1):
        layer = li + 1                      # output of weights[li]
        routes = sim._layer_routes.get(layer)
        if not routes:
            continue
        asn = sim.mapping.cores_of_layer(layer)
        n_post = int(sim.weights[li].shape[1])
        vec = np.ones(n_post, np.float32)
        for a, fr in zip(asn, routes):
            vec[a.neuron_lo:a.neuron_hi] = np.float32(
                (1.0 - p) ** int(fr.hops))
        if np.all(vec >= 1.0):
            continue                        # zero-hop delivery: no exposure
        keep_p[li] = vec
        any_active = True
    if not any_active:
        return None
    return DropPlan(key_seed=derive_fault_seed(faults.seed, _SALT_DROP),
                    keep_p=tuple(keep_p))
