"""The port's faults (`repro_torch.faults`, the fault path of
`repro_torch.compiler` and of both engines) against the JAX package's
`repro.faults`, on the CPU.

* the threefry primitives on their known answers, and `DropPlan.mask`
  bitwise equal to jax's `bernoulli(fold_in(fold_in(PRNGKey(s), li), t))`;
* config values (`FaultConfig`, `sample_faults`, `masked_adjacency`,
  `describe`) equal to the reference's;
* post-fault state: weights, register words and the drop plan bitwise
  equal after construction (float simulators under topology faults,
  quantized ones under codebook faults as well);
* the reference's `ValueError`s;
* whole runs under faults: both port engines against the reference's
  compiled engine on tie-free trains — output counts and every integer
  counter equal, `ChipReport` fields within 1e-6 relative;
* `compile_network(faults=)` and `repair` equal to the reference's;
* `survivability_study` equal;
* zero cost off: a null `FaultConfig` issues the same aten ops as none.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import compiler as REF_COMP  # noqa: E402
from repro import faults as REF_F  # noqa: E402
from repro.compiler.ir import from_layer_sizes as ref_from_layer_sizes  # noqa: E402
from repro.core import noc as REF_NOC  # noqa: E402
from repro.core.quant import CodebookConfig as RefCodebookConfig  # noqa: E402
from repro.core.soc import ChipSimulator as RefChipSimulator  # noqa: E402
from test_torch_harness import (assert_reports_close,  # noqa: E402
                                port_from_reference, reference_arrays,
                                run_raw_ops, tie_free_trains)

from repro_torch import ChipSimulator, convert  # noqa: E402
from repro_torch import compiler as COMP  # noqa: E402
from repro_torch import faults as F  # noqa: E402
from repro_torch.compiler.ir import from_layer_sizes  # noqa: E402
from repro_torch.core import noc as NOC  # noqa: E402
from repro_torch.faults import _threefry as TF  # noqa: E402

SIZES = [64, 96, 96, 16]          # widths stay multiples of 16 (fused pack)
BATCH, STEPS = 4, 6
# (name, FaultConfig fields, quantized): the reference test's config
# (heavy drop: few spikes reach layer 3), a mild one with a failed link,
# and codebook corruption on a quantized chip (stuck + bit-flip) with a
# dead core, a failed router and a drop
CONFIGS = {
    "reference": (dict(dead_cores=(14,), failed_routers=(3,), drop_p=0.15,
                       seed=7), False),
    "mild": (dict(dead_cores=(14,), failed_links=((0, 12),), drop_p=0.02,
                  seed=3), False),
    "codebook": (dict(dead_cores=(30,), failed_routers=(3,), drop_p=0.02,
                      seed=5, codebook_faults=(
                          ("stuck", 12, 1, 0, 3), ("bitflip", 25, 2, 1, 0),
                          ("bitflip", 31, 5, 6, 0))), True),
}
QCFG = dict(n_levels=8, bit_width=8, zero_level=True)


def _weights(sizes=SIZES, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, scale / np.sqrt(a), (a, b)).astype(np.float32)
            for a, b in zip(sizes[:-1], sizes[1:])]


def _trains(sizes=SIZES, batch=BATCH, T=STEPS, seed=1, density=0.25):
    rng = np.random.default_rng(seed)
    return (rng.random((batch, T, sizes[0])) < density).astype(np.float32)


def _configs(name):
    """(reference FaultConfig, port FaultConfig, quantized) of CONFIGS."""
    fields, quantized = CONFIGS[name]
    fields = dict(fields)
    cbf = fields.pop("codebook_faults", ())
    ref = REF_F.FaultConfig(codebook_faults=tuple(
        REF_F.CodebookFault(kind=k, core_id=c, word=w, bit=b, value=v)
        for k, c, w, b, v in cbf), **fields)
    port = F.FaultConfig(codebook_faults=tuple(
        F.CodebookFault(kind=k, core_id=c, word=w, bit=b, value=v)
        for k, c, w, b, v in cbf), **fields)
    return ref, port, quantized


def _ref_sim(name, engine="compiled", trace=None, faults=True):
    ref_f, _, quantized = _configs(name)
    qcfg = RefCodebookConfig(**QCFG) if quantized else None
    return RefChipSimulator([jax.numpy.asarray(w) for w in _weights()],
                            quant_cfg=qcfg, engine=engine, trace=trace,
                            faults=ref_f if faults else None)


def _port_sim(name, ref, engine):
    _, port_f, _ = _configs(name)
    return port_from_reference(ref, engine=engine, faults=port_f,
                               weights=_weights())


@pytest.fixture(scope="module")
def ref_sims():
    return {name: _ref_sim(name) for name in CONFIGS}


# ---------------------------------------------------------------------------
# threefry and the drop masks


@pytest.mark.parametrize("key,count,want", [
    ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
     (0xc4923a9c, 0x483df7a0)),
    ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
], ids=["random123", "zeros"])
def test_threefry_known_answers(key, count, want):
    y = TF.threefry2x32(tuple(torch.tensor(k) for k in key),
                        torch.tensor(count[0]), torch.tensor(count[1]))
    assert tuple(int(v) for v in y) == want


@pytest.mark.parametrize("seed", [0, 7, 3000000000, 2**32 - 1])
def test_prng_key_matches_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).tolist()
    assert [int(k) for k in TF.prng_key(seed)] == want


def _keep_p(kind, n, rng):
    if kind == "hops":
        return np.float32((1 - 0.15) ** rng.integers(1, 20, n))
    return np.full(n, {"0.85": 0.85, "one": 1.0, "tiny": 1e-7}[kind],
                   np.float32)


@pytest.mark.parametrize("kind", ["0.85", "hops", "one", "tiny"])
@pytest.mark.parametrize("key_seed", [
    0, 7, 2**31 - 1, 2**31, 2**32 - 1, F.derive_fault_seed(7, 4),
    F.derive_fault_seed(123, 4)])
def test_drop_mask_bitwise_equal_to_jax(key_seed, kind):
    rng = np.random.default_rng(key_seed % 1000)
    for n in (1, 10, 64, 4096):
        keep = tuple(_keep_p(kind, n, rng) for _ in range(3))
        port = F.DropPlan(key_seed=key_seed, keep_p=keep)
        ref = REF_F.DropPlan(key_seed=key_seed, keep_p=keep)
        for li in range(3):
            rows = port.masks(li, 20, "cpu")
            for t in (0, 1, 19, 1000):
                want = np.asarray(ref.mask(li, t))
                got = port.mask(li, t, "cpu").numpy()
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{n} {li} {t}")
                if t < 20:
                    np.testing.assert_array_equal(rows[t].numpy(), want)


def test_drop_seed_changes_the_loss_pattern():
    def plan(seed):
        return ChipSimulator(_weights(), faults=F.FaultConfig(
            drop_p=0.15, seed=seed), device="cpu").drop_plan

    m1 = plan(1).mask(0, 0, "cpu")
    assert not torch.equal(m1, plan(2).mask(0, 0, "cpu"))
    assert torch.equal(m1, plan(1).mask(0, 0, "cpu"))
    assert not torch.equal(m1, plan(1).mask(0, 1, "cpu"))


def test_drop_masks_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    plan = F.DropPlan(key_seed=7, keep_p=(np.full(8, 0.5, np.float32),))
    for draw in (lambda: plan.mask(0, 0), lambda: plan.masks(0, 4),
                 lambda: plan.layer_key(0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            draw()


# ---------------------------------------------------------------------------
# config values


def test_fault_config_values_equal_reference():
    for name in CONFIGS:
        ref_f, port_f, _ = _configs(name)
        assert port_f.describe() == ref_f.describe()
        for pred in ("is_null", "topology_faults", "blocked_nodes"):
            assert getattr(port_f, pred)() == getattr(ref_f, pred)()
        assert (port_f.with_rerouted().describe()
                == ref_f.with_rerouted().describe())
    assert F.NULL_FAULTS.is_null() and F.FaultConfig().describe() == \
        REF_F.FaultConfig().describe()
    with pytest.raises(ValueError):
        F.FaultConfig(drop_p=1.0)
    with pytest.raises(ValueError):
        F.CodebookFault(core_id=12, word=0, kind="melt")


@pytest.mark.parametrize("word", [-128, -3, 0, 5, 127])
@pytest.mark.parametrize("bit", [0, 3, 7])
def test_codebook_fault_apply_equal_reference(word, bit):
    for kind in ("bitflip", "stuck"):
        kw = dict(core_id=12, word=0, kind=kind, bit=bit, value=-7)
        assert (F.CodebookFault(**kw).apply(word, 8)
                == REF_F.CodebookFault(**kw).apply(word, 8))


@pytest.mark.parametrize("seed,trial", [(0, 0), (5, 0), (5, 1), (6, 3)])
def test_sample_faults_equal_reference(seed, trial):
    kw = dict(router_kills=2, core_kills=1, link_kills=2, drop_p=0.05,
              trial=trial)
    got = F.sample_faults(seed, routers=NOC.router_ids(),
                          cores=NOC.core_ids(),
                          adj=NOC.fullerene_adjacency(), **kw)
    want = REF_F.sample_faults(seed, routers=REF_NOC.router_ids(),
                               cores=REF_NOC.core_ids(),
                               adj=REF_NOC.fullerene_adjacency(), **kw)
    assert got.describe() == want.describe()
    assert F.derive_fault_seed(seed, trial) == \
        REF_F.derive_fault_seed(seed, trial)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_masked_adjacency_equal_reference(name):
    ref_f, port_f, _ = _configs(name)
    for adj in (NOC.fullerene_adjacency(), NOC.multi_domain_adjacency(2)):
        np.testing.assert_array_equal(F.masked_adjacency(adj, port_f),
                                      REF_F.masked_adjacency(adj, ref_f))


# ---------------------------------------------------------------------------
# post-fault state


@pytest.mark.parametrize("name", list(CONFIGS))
def test_post_fault_state_bitwise_equal(ref_sims, name):
    ref = ref_sims[name]
    port = _port_sim(name, ref, "compiled")
    for li, (w, r) in enumerate(zip(port.weights, ref.weights)):
        np.testing.assert_array_equal(w.numpy(), np.asarray(r),
                                      err_msg=f"weights[{li}]")
        np.testing.assert_array_equal(port.nonzero_weights[li].numpy(),
                                      np.asarray(ref.nonzero_weights[li]))
    assert ([rt.codebook_words for rt in port.register_tables]
            == [rt.codebook_words for rt in ref.register_tables])
    assert ([rt.codebook_scale for rt in port.register_tables]
            == [rt.codebook_scale for rt in ref.register_tables])
    assert port.drop_plan.key_seed == ref.drop_plan.key_seed
    for got, want in zip(port.drop_plan.keep_p, ref.drop_plan.keep_p):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    assert [r.links for fl in port._layer_routes.values() for r in fl] == \
        [r.links for fl in ref._layer_routes.values() for r in fl]
    if CONFIGS[name][1]:
        clean = _ref_sim(name, faults=False)
        assert ([rt.codebook_words for rt in ref.register_tables]
                != [rt.codebook_words for rt in clean.register_tables])


def test_harness_builds_from_pre_fault_arrays(ref_sims):
    """A faulted reference holds post-fault tables: a port built from them
    folds the bit-flips in a second time, which undoes them; the harness
    builds from the pre-fault network and gets the reference's chip."""
    ref = ref_sims["codebook"]
    _, port_f, _ = _configs("codebook")
    good = _port_sim("codebook", ref, "compiled")
    assert ([rt.codebook_words for rt in good.register_tables]
            == [rt.codebook_words for rt in ref.register_tables])
    conv = convert(**reference_arrays(ref), device="cpu")
    try:
        twice = ChipSimulator(conv.weights, mapping=conv.mapping,
                              register_tables=conv.register_tables,
                              quant_cfg=ref.quant_cfg, faults=port_f,
                              device="cpu")
    except ValueError as e:               # not table-exact any more
        assert "table-exact" in str(e)
    else:
        assert ([rt.codebook_words for rt in twice.register_tables]
                != [rt.codebook_words for rt in ref.register_tables])
    with pytest.raises(ValueError, match="pre-fault"):
        port_from_reference(ref_sims["mild"], faults=_configs("mild")[1])


def test_rerouted_chip_routes_around_the_failed_router():
    kw = dict(failed_routers=(3,), rerouted=True)
    ref = RefChipSimulator([jax.numpy.asarray(w) for w in _weights()],
                           faults=REF_F.FaultConfig(**kw))
    port = port_from_reference(ref, engine="compiled",
                               faults=F.FaultConfig(**kw),
                               weights=_weights())
    np.testing.assert_array_equal(port.adj, ref.adj)
    links = [r.links for fl in port._layer_routes.values() for r in fl]
    assert links == [r.links for fl in ref._layer_routes.values()
                     for r in fl]
    assert all(3 not in uv for fl in links for uv in fl)
    for w, r in zip(port.weights, ref.weights):
        np.testing.assert_array_equal(w.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# error cases: the reference's ValueErrors


def _both_raise(build_ref, build_port, match):
    with pytest.raises(ValueError, match=match) as want:
        build_ref()
    with pytest.raises(ValueError, match=match) as got:
        build_port()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", [
    "node outside", "link outside", "unquantized", "unmapped core",
    "word outside"])
def test_fault_errors_match_reference(case):
    ws = _weights()
    stuck = dict(kind="stuck", value=3, word=0)
    fields, quant, match = {
        "node outside": (dict(dead_cores=(47,)), False, "outside"),
        "link outside": (dict(failed_links=((0, 99),)), None, "outside"),
        "unquantized": (dict(codebook_faults=(("cbf", dict(core_id=12,
                                                           **stuck)),)),
                        False, "quantized"),
        "unmapped core": (dict(codebook_faults=(("cbf", dict(core_id=0,
                                                             **stuck)),)),
                          True, "unmapped"),
        "word outside": (dict(codebook_faults=(("cbf", dict(
            core_id=12, kind="stuck", value=3, word=8)),)), True,
            "outside"),
    }[case]

    def config(mod):
        f = dict(fields)
        if "codebook_faults" in f:
            f["codebook_faults"] = tuple(mod.CodebookFault(**kw)
                                         for _, kw in f["codebook_faults"])
        return mod.FaultConfig(**f)

    if quant is None:
        _both_raise(
            lambda: REF_F.masked_adjacency(REF_NOC.fullerene_adjacency(),
                                           config(REF_F)),
            lambda: F.masked_adjacency(NOC.fullerene_adjacency(),
                                       config(F)), match)
        return
    ref_q = RefCodebookConfig(**QCFG) if quant else None
    ref = RefChipSimulator([jax.numpy.asarray(w) for w in ws],
                           quant_cfg=ref_q)
    _both_raise(
        lambda: RefChipSimulator([jax.numpy.asarray(w) for w in ws],
                                 quant_cfg=ref_q, mapping=ref.mapping,
                                 faults=config(REF_F)),
        lambda: port_from_reference(ref, engine="compiled",
                                    faults=config(F), weights=ws), match)


def _board(mod_ir, mod_comp):
    sizes = [64] + [96] * 8 + [16]
    return (mod_ir(sizes),
            mod_comp.ChipSpec(neurons_per_core=8, max_domains=8))


def test_repair_errors_match_reference():
    kw = dict(seed=0, anneal_iters=800)
    net, spec = _board(from_layer_sizes, COMP)
    rnet, rspec = _board(ref_from_layer_sizes, REF_COMP)
    prev = COMP.compile_network(net, spec, **kw)      # spread fills every core
    rprev = REF_COMP.compile_network(rnet, rspec, **kw)
    used = sorted({int(c) for c in prev.placement.assignment.values()})
    _both_raise(lambda: REF_COMP.repair(rnet, rprev, REF_F.FaultConfig(
                    dead_cores=(used[0],)), **kw),
                lambda: COMP.repair(net, prev, F.FaultConfig(
                    dead_cores=(used[0],)), **kw), "usable cores")
    small = [48, 64, 16]
    kw = dict(seed=0, anneal_iters=400)
    prev = COMP.compile_network(from_layer_sizes(small), **kw)
    rprev = REF_COMP.compile_network(ref_from_layer_sizes(small), **kw)
    _both_raise(
        lambda: REF_COMP.repair(ref_from_layer_sizes(small), rprev,
                                REF_F.FaultConfig(failed_routers=tuple(
                                    REF_NOC.router_ids())), **kw),
        lambda: COMP.repair(from_layer_sizes(small), prev,
                            F.FaultConfig(failed_routers=tuple(
                                NOC.router_ids())), **kw), None)


# ---------------------------------------------------------------------------
# whole runs under faults


@pytest.fixture(scope="module")
def reference_runs(ref_sims):
    """Per config: tie-free trains and the reference compiled engine's
    counters, counts and reports on them."""
    out = {}
    for name, ref in ref_sims.items():
        port = _port_sim(name, ref, "compiled")
        drop = [None if m is None else m.numpy()
                for m in port.compiled_engine()._drop_masks(STEPS)]
        trains = tie_free_trains([w.numpy() for w in port.weights],
                                 port.lif, (BATCH, STEPS, SIZES[0]),
                                 drop=drop)
        ys = ref.compiled_engine().run_raw(jax.numpy.asarray(trains))
        counts, reports = ref.run_batch(jax.numpy.asarray(trains))
        out[name] = (trains, {k: np.asarray(v) for k, v in ys.items()},
                     np.asarray(counts), reports)
    return out


INT_KEYS = ("nnz", "touched", "fired", "wall")


@pytest.mark.parametrize("engine", ["compiled", "fused"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_faulted_run_matches_reference(ref_sims, reference_runs, name,
                                       engine):
    trains, ref_ys, ref_counts, ref_reports = reference_runs[name]
    port = _port_sim(name, ref_sims[name], engine)
    if engine == "fused":
        assert port.fused_engine().codebook_layers == (
            len(SIZES) - 1 if CONFIGS[name][1] else 0)
    ys, counts = port.array_engine().run_raw(trains)
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    keys = [k for k in ref_ys if k in INT_KEYS or k.startswith("fired_core")]
    assert sorted(k for k in ys if k != "skip_words") == sorted(keys)
    for k in keys:
        np.testing.assert_array_equal(ys[k].numpy(), ref_ys[k], err_msg=k)
    _, reports = port.run_batch(trains)
    assert_reports_close(reports, ref_reports)


def test_faults_change_the_output():
    trains = _trains()
    clean, _ = ChipSimulator(_weights(), device="cpu").run_batch(trains)
    faulty, _ = ChipSimulator(_weights(), device="cpu",
                              faults=_configs("mild")[1]).run_batch(trains)
    assert not torch.equal(clean, faulty)


@pytest.mark.parametrize("engine", ["compiled", "fused"])
def test_transient_dispatch_fault_raises_then_clears(engine):
    sim = ChipSimulator(_weights(), engine=engine, device="cpu",
                        faults=F.FaultConfig(transient_dispatches=(0, 2)))
    trains = _trains(batch=2, T=4)
    with pytest.raises(F.TransientChipFault, match="dispatch 0"):
        sim.run_batch(trains)
    counts, _ = sim.run_batch(trains)            # dispatch 1: healthy again
    with pytest.raises(F.TransientChipFault, match="dispatch 2"):
        sim.run_batch(trains)
    clean, _ = ChipSimulator(_weights(), engine=engine, device="cpu",
                             mapping=sim.mapping).run_batch(trains)
    assert torch.equal(counts, clean)


# ---------------------------------------------------------------------------
# zero cost off


@pytest.mark.parametrize("engine", ["compiled", "fused"])
def test_null_faults_issue_the_same_ops(engine):
    trains = _trains(batch=2, T=3)
    base = ChipSimulator(_weights(), engine=engine, device="cpu")
    ops, ys, counts = run_raw_ops(base, trains)
    for faults in (F.NULL_FAULTS, F.FaultConfig(seed=9)):
        sim = ChipSimulator(_weights(), engine=engine, device="cpu",
                            mapping=base.mapping, faults=faults)
        assert sim.drop_plan is None
        got_ops, got_ys, got_counts = run_raw_ops(sim, trains)
        assert got_ops == ops
        assert torch.equal(got_counts, counts)
        assert got_ys.keys() == ys.keys()
        for k in ys:
            assert torch.equal(got_ys[k], ys[k]), k


def test_active_drop_plan_changes_the_ops():
    trains = _trains(batch=2, T=3)
    base = ChipSimulator(_weights(), device="cpu")
    sim = ChipSimulator(_weights(), device="cpu", mapping=base.mapping,
                        faults=F.FaultConfig(drop_p=0.2, seed=3))
    assert run_raw_ops(sim, trains)[0] != run_raw_ops(base, trains)[0]


# ---------------------------------------------------------------------------
# the compiler's fault path


@pytest.fixture(scope="module")
def boards():
    kw = dict(seed=0, anneal_iters=800)
    net, spec = _board(from_layer_sizes, COMP)
    rnet, rspec = _board(ref_from_layer_sizes, REF_COMP)
    return (net, spec, COMP.compile_network(net, spec, **kw),
            rnet, rspec, REF_COMP.compile_network(rnet, rspec, **kw))


def _flows(compiled):
    return {li: [dataclasses.astuple(f) for f in fl]
            for li, fl in compiled.routed.layer_flows.items()}


def _same_compile(got, want):
    assert got.placement.assignment == want.placement.assignment
    assert got.cost == want.cost
    assert _flows(got) == _flows(want)
    assert got.faults.describe() == want.faults.describe()
    assert got.summary() == want.summary()


@pytest.mark.parametrize("fields,spread", [
    (dict(failed_routers=(3,)), True), (dict(failed_routers=(3,)), False),
    (dict(failed_links=((0, 12), (3, 14))), True),
    (dict(dead_cores="first", failed_routers=(5,)), False)],
    ids=["router", "router-packed", "links", "dead-core"])
def test_repair_matches_reference(fields, spread):
    kw = dict(seed=0, anneal_iters=800, spread=spread)
    net, spec = _board(from_layer_sizes, COMP)
    rnet, rspec = _board(ref_from_layer_sizes, REF_COMP)
    prev = COMP.compile_network(net, spec, **kw)
    rprev = REF_COMP.compile_network(rnet, rspec, **kw)
    fields = dict(fields)
    if fields.get("dead_cores") == "first":   # packed: spare cores remain
        fields["dead_cores"] = (min(prev.placement.assignment.values()),)
    rep = COMP.repair(net, prev, F.FaultConfig(**fields), **kw)
    want = REF_COMP.repair(rnet, rprev, REF_F.FaultConfig(**fields), **kw)
    _same_compile(rep, want)
    assert rep.recompile_stats == want.recompile_stats
    assert rep.faults.rerouted
    used = {int(n) for fl in rep.routed.layer_flows.values()
            for f in fl for uv in f.links for n in uv}
    assert not set(fields.get("failed_routers", ())) & used
    assert not (set(fields.get("dead_cores", ()))
                & set(rep.placement.assignment.values()))
    bad = {tuple(sorted(uv)) for uv in fields.get("failed_links", ())}
    assert not any(tuple(sorted(uv)) in bad
                   for fl in rep.routed.layer_flows.values()
                   for f in fl for uv in f.links)
    fresh = COMP.compile_network(
        net, spec, faults=F.FaultConfig(**fields).with_rerouted(), **kw)
    _same_compile(fresh, REF_COMP.compile_network(
        rnet, rspec, faults=REF_F.FaultConfig(**fields).with_rerouted(),
        **kw))
    assert fresh.placement.assignment == rep.placement.assignment


def test_router_repair_reuses_every_placement(boards):
    net, spec, prev, *_ = boards
    rep = COMP.repair(net, prev, F.FaultConfig(failed_routers=(3,)),
                      seed=0, anneal_iters=800)
    assert rep.recompile_stats["reused"] == rep.recompile_stats["domains"]


def test_repaired_network_runs_like_the_reference(boards):
    net, spec, prev, rnet, rspec, rprev = boards
    kw = dict(seed=0, anneal_iters=800)
    rep = COMP.repair(net, prev, F.FaultConfig(failed_routers=(3,)), **kw)
    rrep = REF_COMP.repair(rnet, rprev,
                           REF_F.FaultConfig(failed_routers=(3,)), **kw)
    sizes = [64] + [96] * 8 + [16]
    ws = _weights(sizes, scale=2.0)
    ref = RefChipSimulator([jax.numpy.asarray(w) for w in ws],
                           mapping=rrep.to_soc_mapping(), faults=rrep.faults)
    port = ChipSimulator(ws, mapping=rep.to_soc_mapping(), faults=rep.faults,
                         device="cpu")
    trains = _trains(sizes, batch=2, T=4)
    counts, reports = port.run_batch(trains)
    rcounts, rreports = ref.run_batch(jax.numpy.asarray(trains))
    assert counts.shape == (2, 16)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    assert_reports_close(reports, rreports)


# ---------------------------------------------------------------------------
# survivability


@pytest.mark.parametrize("k,trials,seed", [(4, 8, 0), (2, 4, 3), (6, 3, 1)])
def test_survivability_study_equal_reference(k, trials, seed):
    got = F.survivability_study(k=k, trials=trials, seed=seed)
    assert got == REF_F.survivability_study(k=k, trials=trials, seed=seed)
    if k == 4:
        assert got["routable_ratio_vs_mesh"] > 1.0


def test_masked_graph_metrics_equal_reference():
    adj = NOC.fullerene_adjacency(with_level2=True)
    f = F.FaultConfig(failed_routers=(0, 1, 2, 5))
    rf = REF_F.FaultConfig(failed_routers=(0, 1, 2, 5))
    m, rm = F.masked_adjacency(adj, f), REF_F.masked_adjacency(adj, rf)
    eps = NOC.core_ids()
    assert F.routable_fraction(m, eps) == REF_F.routable_fraction(rm, eps)
    assert (F.masked_saturation_rate(m, eps)
            == REF_F.masked_saturation_rate(rm, eps))
