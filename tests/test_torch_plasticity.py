"""The port's on-chip plasticity (`repro_torch.core.plasticity`, the
projection `quant.project_to_codebook`, the learnable layers of the three
engines) against the JAX package's `repro.core.plasticity`, on the CPU.

Fixtures are the reference suite's (tests/test_plasticity.py): SIZES
64-96-96-16, an 8-level 8-bit codebook, lr 0.4, B 1 and 4, T 6.

* `project_to_codebook` bitwise equal to the reference's, shared and
  per-column tables, duplicate levels and +inf rows;
* the rule functions: traces within 2 ulp (XLA may contract
  `x * decay + s` into an FMA), indexes equal, on a fixture whose
  candidates all lie clear of the midpoints between levels;
* whole runs against the reference: tests/test_torch_plasticity_runs.py;
* inside the port, fused equals compiled bitwise under both rules;
* zero cost off: plasticity None, NULL_PLASTICITY and a default
  PlasticityConfig() issue the same aten ops;
* the reference's error cases.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import plasticity as REF_PLC  # noqa: E402
from repro.core import quant as REF_Q  # noqa: E402
from repro.core.energy import WeightWriteModel as RefWriteModel  # noqa: E402
from repro.core.zspe import CycleModel as RefCycleModel  # noqa: E402
from test_torch_harness import (  # noqa: E402
    PLASTIC_ENGINES as ENGINES, PLASTIC_REWARD as REWARD,
    PLASTIC_SIZES as SIZES, PLASTIC_STDP as STDP,
    assert_learned_equal as _assert_learned_equal, assert_reports_close,
    plastic_port_sim as _port_sim, plastic_trains as _trains,
    plastic_weights as _weights, run_raw_ops)

from repro_torch import (NULL_PLASTICITY, ChipSimulator,  # noqa: E402
                         CodebookConfig, PlasticityConfig)
from repro_torch.core import plasticity as PLC  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.core.energy import WeightWriteModel  # noqa: E402
from repro_torch.core.zspe import CycleModel  # noqa: E402

MAX_ULP = 2


# ---------------------------------------------------------------------------
# the projection


def _levels(rng, n, cols=None):
    """Codebook levels with a duplicate; per column, +inf rows past each
    column's own table size (as the lowering pads them)."""
    if cols is None:
        cb = np.sort(rng.normal(0, 1, n)).astype(np.float32)
        cb[3] = cb[2]
        return cb
    cb = rng.normal(0, 1, (n, cols)).astype(np.float32)
    cb[2] = cb[1]
    for j in range(cols):
        cb[rng.integers(n // 2, n + 1):, j] = np.inf
    return cb


@pytest.mark.parametrize("form", ["shared", "per-column"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_project_to_codebook_bitwise_equal(form, seed):
    rng = np.random.default_rng(seed)
    cols = 37
    cb = _levels(rng, 8, None if form == "shared" else cols)
    v = rng.normal(0, 1.2, (3, 29, cols)).astype(np.float32)
    # candidates on every level, on the midpoints, and far outside
    finite = cb[np.isfinite(cb)]
    v.flat[:len(finite)] = finite
    v.flat[len(finite):2 * len(finite) - 1] = (finite[:-1] + finite[1:]) / 2
    v[0, 0, :4] = (-1e30, 1e30, 0.0, -0.0)
    got = Q.project_to_codebook(torch.tensor(v), torch.tensor(cb))
    want = np.asarray(REF_Q.project_to_codebook(v, cb))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    if form == "per-column":
        assert np.isfinite(cb[got.numpy().astype(np.int64),
                              np.arange(cols)]).all()
    # idempotent on its own levels, duplicates included
    lv = torch.tensor(cb).gather(0, got.reshape(-1, cols).long()) \
        if form == "per-column" else torch.tensor(cb)[got.long()]
    again = Q.project_to_codebook(lv.reshape(v.shape), torch.tensor(cb))
    assert torch.equal(again, got)


def test_project_to_codebook_rejects_bad_tables():
    v = torch.zeros((4, 5))
    with pytest.raises(ValueError, match="codebook must be"):
        Q.project_to_codebook(v, torch.zeros((8, 6)))
    with pytest.raises(ValueError, match="codebook must be"):
        Q.project_to_codebook(v, torch.zeros((2, 8, 5)))


@pytest.mark.parametrize("levels,value,want", [
    ((-0.5, 0.25, 1.0, np.inf), np.inf, 3),
    ((-0.5, np.nan, 1.0), 0.9, 1),
    ((np.nan, 0.0, np.nan), 0.5, 0),
    ((-0.5, 0.25, np.inf, np.inf), np.inf, 2),
], ids=["inf-level", "nan-level", "first-nan", "two-inf-levels"])
def test_project_to_codebook_nan_distance_like_argmin(levels, value, want):
    """A NaN distance wins as in `jnp.argmin`, the first one kept: +inf
    against the lowering's +inf fill keeps that level, and a NaN level
    beats a closer finite one."""
    cb = np.asarray(levels, np.float32)
    v = np.full((2, 3), value, np.float32)
    ref = np.asarray(REF_Q.project_to_codebook(v, cb))
    assert (ref == want).all()
    got = Q.project_to_codebook(torch.tensor(v), torch.tensor(cb))
    np.testing.assert_array_equal(got.numpy(), ref)
    # per-column tables: the same rule column by column
    cbc = np.repeat(cb[:, None], 3, axis=1)
    got = Q.project_to_codebook(torch.tensor(v), torch.tensor(cbc))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(REF_Q.project_to_codebook(v, cbc)))


def test_gather_index_is_jax_gather_rule():
    """Measured against the reference with L = 8: -1, 8, 100 and 127 read
    level 7, -3 level 5, -8 and -128 level 0."""
    idx = np.array([[-1, 8, 100, 127], [-3, -8, -128, 4]], np.int8)
    cbw = np.repeat(np.arange(8, dtype=np.float32)[:, None], 4, axis=1)
    want = np.asarray(REF_PLC.dequant_indices(jax.numpy.asarray(idx),
                                              jax.numpy.asarray(cbw)))
    np.testing.assert_array_equal(want, [[7, 7, 7, 7], [5, 0, 0, 4]])
    got = PLC.dequant_indices(torch.tensor(idx), torch.tensor(cbw))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(Q.gather_index(torch.tensor(idx), 8),
                                  want.astype(np.int64))


# ---------------------------------------------------------------------------
# the rule functions, teacher-forced


def _rule_inputs(seed=0, batch=3, k=48, n=40, levels=8):
    rng = np.random.default_rng(seed)
    cfg_words = rng.integers(-127, 128, (levels, n))
    cbw = (cfg_words * np.float32(0.011)).astype(np.float32)
    for j in range(n):                 # some columns hold fewer levels
        cbw[rng.integers(levels - 2, levels + 1):, j] = np.inf
    top = np.isfinite(cbw).sum(0)
    idx = (rng.random((batch, k, n)) * top).astype(np.int8)
    return dict(
        pre=(rng.random((batch, k)) < 0.3).astype(np.float32),
        post=(rng.random((batch, n)) < 0.2).astype(np.float32),
        x_pre=rng.random((batch, k)).astype(np.float32) * 2,
        x_post=rng.random((batch, n)).astype(np.float32) * 2,
        elig=rng.normal(0, 1, (batch, k, n)).astype(np.float32),
        idx=idx, cbw=cbw)


def _midpoint_margin(cand, cbw):
    """Per candidate, how far (f64) it lies from the nearest midpoint
    between two distinct levels of its column: where rounding could move
    the projection."""
    d = np.abs(np.asarray(cand, np.float64)[..., None, :]
               - cbw.astype(np.float64))                 # (..., L, n)
    d = np.where(np.isfinite(d), d, np.inf)
    best = d.min(axis=-2)
    nearest = np.take_along_axis(cbw.astype(np.float64)[None, None],
                                 d.argmin(axis=-2)[..., None, :],
                                 axis=-2)[..., 0, :]
    other = np.where(cbw.astype(np.float64)[None, None] == nearest[..., None, :],
                     np.inf, d).min(axis=-2)
    return other - best


def _tensors(inp):
    return {k: torch.tensor(v) for k, v in inp.items()}


@pytest.mark.parametrize("cfg", [
    dict(enabled=True, lr=0.4), dict(enabled=True, lr=0.05, a_plus=0.7,
                                     a_minus=1.3, tau_pre=3.0, tau_post=1.5)],
    ids=["reference-suite", "asymmetric"])
def test_stdp_step_matches_reference(cfg):
    inp = _rule_inputs()
    t = _tensors(inp)
    port_cfg, ref_cfg = PlasticityConfig(**cfg), REF_PLC.PlasticityConfig(**cfg)
    got = PLC.stdp_step(port_cfg, t["pre"], t["post"], t["x_pre"],
                        t["x_post"], t["idx"], t["cbw"])
    want = REF_PLC.stdp_step(ref_cfg, inp["pre"], inp["post"], inp["x_pre"],
                             inp["x_post"], inp["idx"], inp["cbw"])
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), MAX_ULP)
    # the fixture's candidates lie clear of every midpoint, so an ulp in
    # the traces cannot move an index
    xp, xq = (np.asarray(a, np.float64) for a in want[1:3])
    pair = (ref_cfg.a_plus * xp[..., :, None] * inp["post"][..., None, :]
            - ref_cfg.a_minus * inp["pre"][..., :, None] * xq[..., None, :])
    w0 = np.take_along_axis(inp["cbw"][None], inp["idx"].astype(np.int64),
                            axis=-2)
    cand = w0 + ref_cfg.lr * pair
    assert _midpoint_margin(cand, inp["cbw"]).min() > 1e-5
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].any() and not got[3].all()


@pytest.mark.parametrize("elig_pre", [0.0, 0.1])
def test_elig_step_matches_reference(elig_pre):
    inp = _rule_inputs(seed=1)
    t = _tensors(inp)
    cfg = dict(enabled=True, mode="reward", elig_pre=elig_pre)
    got = PLC.elig_step(PlasticityConfig(**cfg), t["pre"], t["post"],
                        t["x_pre"], t["x_post"], t["elig"])
    want = REF_PLC.elig_step(REF_PLC.PlasticityConfig(**cfg), inp["pre"],
                             inp["post"], inp["x_pre"], inp["x_post"],
                             inp["elig"])
    for g, w in zip(got, want):
        np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), MAX_ULP)


def _reward(kind, batch, n, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "scalar":
        return np.float32(0.7)
    shape = (n,) if kind == "vector" else (batch, n)
    return rng.choice([-1.0, 0.0, 1.0], shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["scalar", "vector", "per-sample"])
def test_apply_reward_matches_reference(kind):
    inp = _rule_inputs(seed=2)
    t = _tensors(inp)
    cfg = dict(enabled=True, mode="reward", lr=0.4)
    r = _reward(kind, *inp["post"].shape)
    got = PLC.apply_reward(PlasticityConfig(**cfg), t["idx"], t["cbw"],
                           t["elig"], torch.tensor(r))
    want = REF_PLC.apply_reward(REF_PLC.PlasticityConfig(**cfg), inp["idx"],
                                inp["cbw"], inp["elig"], r)
    w0 = np.take_along_axis(inp["cbw"][None], inp["idx"].astype(np.int64),
                            axis=-2)
    rr = r[..., None, :] if np.ndim(r) else r
    cand = w0 + np.float64(0.4) * rr * inp["elig"].astype(np.float64)
    assert _midpoint_margin(cand, inp["cbw"]).min() > 1e-5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].any()


@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_commit_reward_matches_reference(kind):
    inp = _rule_inputs(seed=4)
    t = _tensors(inp)
    cfg = dict(enabled=True, mode="reward", lr=0.4)
    r = _reward(kind, *inp["post"].shape)
    got_l, got = PLC.commit_reward(
        PlasticityConfig(**cfg), [None, (t["idx"][0], t["cbw"])],
        [None, t["idx"]], [None, t["elig"]], r, WeightWriteModel(),
        CycleModel())
    want_l, want = REF_PLC.commit_reward(
        REF_PLC.PlasticityConfig(**cfg), [None, (inp["idx"][0], inp["cbw"])],
        [None, inp["idx"]], [None, inp["elig"]], r, RefWriteModel(),
        RefCycleModel())
    _assert_learned_equal(got_l, want_l)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["weight_writes"].dtype == np.float64


def test_dequant_indices_matches_reference():
    inp = _rule_inputs(seed=5)
    got = PLC.dequant_indices(torch.tensor(inp["idx"]),
                              torch.tensor(inp["cbw"]))
    want = REF_PLC.dequant_indices(inp["idx"], inp["cbw"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_config_matches_reference():
    for kw in ({}, STDP, REWARD, dict(tau_pre=3.5, tau_elig=7.0)):
        got, want = PlasticityConfig(**kw), REF_PLC.PlasticityConfig(**kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.decay_pre, got.decay_post, got.decay_elig) == \
            (want.decay_pre, want.decay_post, want.decay_elig)
        assert [got.learns(li) for li in range(4)] == \
            [want.learns(li) for li in range(4)]
    assert NULL_PLASTICITY == PlasticityConfig()


# ---------------------------------------------------------------------------
# inside the port


@pytest.mark.parametrize("rule", ["stdp", "reward"])
@pytest.mark.parametrize("batch", [1, 4])
def test_fused_bitwise_equal_to_compiled(rule, batch):
    comp = _port_sim("compiled", rule)
    fused = _port_sim("fused", rule, mapping=comp.mapping)
    assert fused.fused_engine().codebook_layers == len(SIZES) - 1
    trains = _trains(batch=batch)
    ys_c, c_c = comp.compiled_engine().run_raw(trains)
    ys_f, c_f = fused.fused_engine().run_raw(trains)
    assert torch.equal(c_f, c_c) and float(c_f.sum()) > 0
    learned = [k for k in ys_c if k.startswith(("learned_idx", "elig"))]
    assert learned and "writes" in ys_c
    for key in ys_c:
        assert torch.equal(ys_f[key], ys_c[key]), key
    _, rep_c = comp.run_batch(trains)
    _, rep_f = fused.run_batch(trains)
    # the fused engine counts skipped spike words untraced, the compiled
    # one only traced; every other field is equal
    assert_reports_close(rep_f, rep_c, rel=0.0)
    assert [(r.stats.weight_writes, r.write_energy_pj) for r in rep_f] == \
        [(r.stats.weight_writes, r.write_energy_pj) for r in rep_c]
    _assert_learned_equal(fused.last_learned, comp.last_learned)
    if rule == "reward":
        info_c = comp.apply_reward(0.5)
        info_f = fused.apply_reward(0.5)
        for k in info_c:
            np.testing.assert_array_equal(info_f[k], info_c[k])
        _assert_learned_equal(fused.last_learned, comp.last_learned)


@pytest.mark.parametrize("engine", ENGINES)
def test_warm_start_resumes_learning(engine):
    trains = _trains()
    sim = _port_sim(engine, "stdp")
    c_cold, _ = sim.run_batch(trains)
    learned = sim.last_learned
    assert learned[0].shape == (4, SIZES[0], SIZES[1])
    c_warm, _ = sim.run_batch(trains, learned=learned)
    assert not torch.equal(c_cold, c_warm)
    c_warm2, _ = sim.run_batch(trains, learned=learned)
    assert torch.equal(c_warm, c_warm2)
    # the run never writes into the caller's tensors
    before = [l.clone() for l in learned if l is not None]
    sim.run_batch(trains, learned=learned)
    assert all(torch.equal(a, b) for a, b in
               zip(before, [l for l in learned if l is not None]))


@pytest.mark.parametrize("engine", ENGINES)
def test_silent_input_writes_nothing(engine):
    """dw == 0 is a projection fixed point: no spikes, no writes."""
    sim = _port_sim(engine, "stdp")
    _, reps = sim.run_batch(np.zeros((2, 6, SIZES[0]), np.float32))
    assert all(r.stats.weight_writes == 0 for r in reps)
    assert all(r.write_energy_pj == 0 for r in reps)
    _assert_learned_equal(
        sim.last_learned,
        [None if pt is None else pt[0].expand(2, -1, -1)
         for pt in sim.plasticity_tables()])


@pytest.mark.parametrize("engine", ["compiled", "fused"])
def test_plasticity_off_issues_the_same_ops(engine):
    trains = _trains(batch=2, T=3)
    base = _port_sim(engine)
    ops, ys, counts = run_raw_ops(base, trains)
    for plast in (NULL_PLASTICITY, PlasticityConfig(),
                  PlasticityConfig(mode="reward", layers=(1,))):
        sim = ChipSimulator(_weights(), engine=engine, device="cpu",
                            quant_cfg=CodebookConfig(8, 8),
                            mapping=base.mapping, plasticity=plast)
        assert sim.array_engine().plast_tables == (None,) * (len(SIZES) - 1)
        got_ops, got_ys, got_counts = run_raw_ops(sim, trains)
        assert got_ops == ops
        assert torch.equal(got_counts, counts)
        assert got_ys.keys() == ys.keys()
        for k in ys:
            assert torch.equal(got_ys[k], ys[k]), k
    stdp = ChipSimulator(_weights(), engine=engine, device="cpu",
                         quant_cfg=CodebookConfig(8, 8),
                         mapping=base.mapping,
                         plasticity=PlasticityConfig(**STDP))
    assert run_raw_ops(stdp, trains)[0] != ops


# ---------------------------------------------------------------------------
# config and error paths (the reference suite's cases)


@pytest.mark.parametrize("engine", ENGINES)
def test_learned_with_plasticity_off_raises(engine):
    sim = _port_sim(engine)
    with pytest.raises(ValueError, match="plasticity"):
        sim.run_batch(_trains(), learned=[None, None, None])


@pytest.mark.parametrize("engine", ENGINES)
def test_apply_reward_needs_reward_mode(engine):
    sim = _port_sim(engine, "stdp")
    sim.run_batch(_trains(batch=1, T=2))
    with pytest.raises(ValueError, match="reward"):
        sim.apply_reward(1.0)


@pytest.mark.parametrize("engine", ENGINES)
def test_apply_reward_needs_a_completed_run(engine):
    sim = _port_sim(engine, "reward")
    with pytest.raises(ValueError, match="completed"):
        sim.apply_reward(1.0)
    sim.run_batch(_trains(batch=1, T=2))
    sim.apply_reward(1.0)
    with pytest.raises(ValueError, match="completed"):
        sim.apply_reward(1.0)


def test_vector_reward_width_mismatch_raises():
    # layers=None makes both hidden layers learnable (96 and 96 and 16
    # wide): a 16-wide error vector cannot broadcast onto all of them
    sim = ChipSimulator(_weights(), engine="compiled", device="cpu",
                        quant_cfg=CodebookConfig(8, 8),
                        plasticity=PlasticityConfig(**dict(REWARD,
                                                           layers=None)))
    sim.run_batch(_trains())
    with pytest.raises(ValueError, match="readout"):
        sim.apply_reward(np.ones(SIZES[-1], np.float32))


def test_plasticity_requires_table_exact_codebooks():
    with pytest.raises(ValueError, match="table-exact"):
        ChipSimulator(_weights(), engine="compiled", device="cpu",
                      plasticity=PlasticityConfig(**STDP)
                      ).plasticity_tables()


def test_bad_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        PlasticityConfig(enabled=True, mode="hebbian")


def test_empty_layer_selection_raises():
    with pytest.raises(ValueError, match="selects none"):
        ChipSimulator(_weights(), engine="compiled", device="cpu",
                      quant_cfg=CodebookConfig(8, 8),
                      plasticity=PlasticityConfig(enabled=True, layers=(99,))
                      ).plasticity_tables()


@pytest.mark.parametrize("learned,match", [
    ([None, None], "one entry per layer"),
    (["idx", None, None], "is frozen"),
    ([None, None, "bad"], "expected"),
], ids=["count", "frozen", "shape"])
def test_bad_learned_raises(learned, match):
    sim = _port_sim("compiled", "reward")
    idx = torch.zeros((SIZES[0], SIZES[1]), dtype=torch.int8)
    bad = torch.zeros((3, SIZES[2], SIZES[3]), dtype=torch.int8)
    learned = [idx if x == "idx" else bad if x == "bad" else x
               for x in learned]
    with pytest.raises(ValueError, match=match):
        sim.run_batch(_trains(), learned=learned)
