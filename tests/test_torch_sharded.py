"""The port's cores-axis ShardedEngine, its learnable layers by columns,
and batch sharding of the array engines over `torch.distributed`, against
the JAX package on the CPU.

The reference's `ShardedEngine` promises spikes bit-identical to the
unsharded CompiledEngine (tests/test_sharded_engine.py) but does not run
under jax 0.9.0 (`shard_map(check_rep=...)`), so the port is held to the
JAX **CompiledEngine** on the same multi-domain mapping
(tests/test_sharded_engine.py's fixtures, 8 neurons a core on up to 4 or
8 domains; tests/test_plasticity.py's for learning):

* (a) one process, no group, S = 1: counts, learned indexes, writes,
  trace counters and the reward commit equal to the JAX compiled engine's
  and report fields within 1e-6, healthy, traced, under a drop plan,
  under STDP and under reward with `apply_reward` and a warm start; every
  counter bitwise the port's compiled engine's;
* (b) the lowering at S = 2 and 4 against the reference's own
  `_lower_shards` / `_lower_plast_shards`, run on an instance made with
  `object.__new__` (nothing in the JAX package changes);
* (c) the reference's invalid shard counts;
* (d) gloo ranks spawned on the CPU (tests/torch_sharded_ranks.py): at
  world 2, S = 2 under every case of (a), and the batch-sharded compiled
  and fused engines bitwise the single-process run; at world 4, a 2 x 2
  batch x cores mesh (an odd batch replicated on both rows) and S = 4;
* in one process with a gloo group of one: every collective carries
  uint8 or int64, never int16 / uint16, and changes nothing.

Trains are tie-free (`tie_free_trains`) where the fixture is not the
reference suite's own, so an ulp between the frameworks cannot flip a
spike.
"""
import datetime

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.compiler import ChipSpec as RefChipSpec  # noqa: E402
from repro.compiler import compile_network as ref_compile  # noqa: E402
from repro.core import engine as REF_ENGINE  # noqa: E402
from repro.core.plasticity import (  # noqa: E402
    PlasticityConfig as RefPlasticityConfig)
from repro.core.quant import CodebookConfig as RefCodebookConfig  # noqa: E402
from repro.core.soc import ChipSimulator as RefChipSimulator  # noqa: E402
from repro.faults import FaultConfig as RefFaultConfig  # noqa: E402
from repro.telemetry.trace import TraceConfig as RefTraceConfig  # noqa: E402
from test_torch_harness import (assert_reports_close,  # noqa: E402
                                port_from_spec, port_spec, tie_free_trains)
from torch_sharded_ranks import run_case, spawn_ranks  # noqa: E402

from repro_torch import PlasticityConfig  # noqa: E402
from repro_torch.core import engine as ENGINE  # noqa: E402
from repro_torch.faults import FaultConfig  # noqa: E402
from repro_torch.telemetry import TraceConfig  # noqa: E402

BOARD = (64, 120, 96, 56, 16)        # test_sharded_engine.py, 2 domains
BOARD4 = (96, 200, 200, 160, 24)     # the same at max_domains 8: 4+
PLAST = (64, 96, 96, 16)             # test_plasticity.py's SIZES
BATCH, STEPS = 4, 8
STDP = dict(enabled=True, mode="stdp", lr=0.4)
REWARD = dict(enabled=True, mode="reward", lr=0.4, elig_pre=0.1, layers=(2,))
DROP = dict(drop_p=0.1, seed=3)
TRACE = dict(enabled=True, skip_words=True)
REWARD_VEC = np.zeros(PLAST[-1], np.float32)
REWARD_VEC[3], REWARD_VEC[7] = 1.0, -1.0


def _weights(sizes, seed, scale=None):
    """Gaussian weights: N(0, 0.5) as test_sharded_engine.py, or
    N(0, 1.2 / sqrt(fan_in)) as test_plasticity.py (scale None)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.2 / np.sqrt(a) if scale is None else scale,
                       (a, b)).astype(np.float32)
            for a, b in zip(sizes[:-1], sizes[1:])]


def _mapping(weights, max_domains):
    cn = ref_compile([np.asarray(w) for w in weights],
                     RefChipSpec(neurons_per_core=8,
                                 max_domains=max_domains), seed=3)
    return cn.to_soc_mapping(), cn.n_domains_used


def _case(name, ref, trains, **port):
    return dict(name=name, ref=ref, trains=trains, port=port)


@pytest.fixture(scope="module")
def cases():
    """Per case: the JAX compiled simulator and the port's configs, on a
    multi-domain mapping, with its trains."""
    w = _weights(BOARD, 1, 0.5)
    m, n_dom = _mapping(w, 4)
    assert n_dom >= 2
    wp = _weights(PLAST, 0)
    mp_, n_dom_p = _mapping(wp, 4)
    assert n_dom_p >= 2
    w4 = _weights(BOARD4, 5, 0.5)
    m4, n_dom4 = _mapping(w4, 8)
    assert n_dom4 >= 4

    def ref(weights, mapping, **kw):
        return RefChipSimulator(weights, mapping=mapping, engine="compiled",
                                **kw)

    healthy = ref(w, m)
    lif = healthy.lif
    trains = tie_free_trains(w, lif, (BATCH, STEPS, BOARD[0]))
    dropped = ref(w, m, faults=RefFaultConfig(**DROP))
    probe = port_from_spec(port_spec(dropped, faulted=True, weights=w),
                           "compiled", faults=FaultConfig(**DROP))
    drop = [None if x is None else x.numpy()
            for x in probe.compiled_engine()._drop_masks(STEPS)]
    qcfg = RefCodebookConfig(8, 8)
    plast_trains = (np.random.default_rng(1).random(
        (BATCH, 6, PLAST[0])) < 0.25).astype(np.float32)
    out = {
        "healthy": _case("healthy", healthy, trains),
        "traced": _case("traced", ref(w, m, trace=RefTraceConfig(**TRACE)),
                        trains, trace=TraceConfig(**TRACE)),
        "dropped": _case("dropped", dropped, tie_free_trains(
            w, lif, (BATCH, STEPS, BOARD[0]), drop=drop),
            faults=FaultConfig(**DROP), weights=w),
        "stdp": _case("stdp", ref(wp, mp_, quant_cfg=qcfg,
                                  plasticity=RefPlasticityConfig(**STDP)),
                      plast_trains, plasticity=PlasticityConfig(**STDP)),
        "reward": _case("reward", ref(wp, mp_, quant_cfg=qcfg,
                                      plasticity=RefPlasticityConfig(
                                          **REWARD)),
                        plast_trains, plasticity=PlasticityConfig(**REWARD),
                        reward=REWARD_VEC),
        "odd": _case("odd", healthy, trains[:3]),
        "board4": _case("board4", ref(w4, m4), tie_free_trains(
            w4, lif, (BATCH, STEPS, BOARD4[0]))),
        "quantized": _case("quantized", ref(wp, mp_, quant_cfg=qcfg),
                           plast_trains),
    }
    for c in out.values():
        c["spec"] = port_spec(c["ref"], faulted="faults" in c["port"],
                              weights=c["port"].get("weights"))
    return out


@pytest.fixture(scope="module")
def ref_runs(cases):
    """The JAX compiled engine's results per case, as `run_case` names
    them."""
    out = {}
    for name, c in cases.items():
        ref = c["ref"]
        trains = jax.numpy.asarray(c["trains"])
        counts, reports = ref.run_batch(trains)
        r = {"counts": np.asarray(counts), "reports": reports,
             "learned": ref.last_learned, "trace": ref.last_trace()}
        if "reward" in c["port"]:
            r["reward_info"] = ref.apply_reward(c["port"]["reward"])
            r["committed"] = ref.last_learned
            counts_w, r["warm_reports"] = ref.run_batch(
                trains, learned=ref.last_learned)
            r["warm_counts"] = np.asarray(counts_w)
        out[name] = r
    return out


def _port_case(c, engine, **extra):
    """The plain-data case `run_case` takes (in this process or a rank)."""
    port = {k: v for k, v in c["port"].items() if k != "weights"}
    return dict(spec=c["spec"], engine=engine, trains=c["trains"], **port,
                **extra)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_learned(got, want, msg):
    assert (got is None) == (want is None), msg
    if want is None:
        return
    assert len(got) == len(want), msg
    for g, w in zip(got, want):
        assert (g is None) == (w is None), msg
        if w is not None:
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=msg)


def _assert_matches_reference(got: dict, want: dict, msg: str) -> None:
    """A port run (`run_case`) against the JAX compiled engine's: counts,
    learned indexes, writes and trace counters equal, report fields within
    1e-6, and the reward commit and warm run when there was one."""
    np.testing.assert_array_equal(_np(got["counts"]), want["counts"],
                                  err_msg=msg)
    assert_reports_close(got["reports"], want["reports"])
    for a, b in zip(got["reports"], want["reports"]):
        assert a.stats.weight_writes == b.stats.weight_writes, msg
        assert abs(a.write_energy_pj - b.write_energy_pj) <= 1e-6 * max(
            abs(b.write_energy_pj), 1.0), msg
    _assert_learned(got["learned"], want["learned"], f"{msg}: learned")
    if want["trace"] is not None:
        for f in ("fired", "touched", "skip_words", "weight_writes"):
            a, b = getattr(got["trace"], f), getattr(want["trace"], f)
            assert (a is None) == (b is None), (msg, f)
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{msg}: {f}")
    else:
        assert got["trace"] is None, msg
    if "reward_info" in want:
        for k in ("weight_writes", "write_cycles"):
            np.testing.assert_array_equal(got["reward_info"][k],
                                          want["reward_info"][k],
                                          err_msg=msg)
        np.testing.assert_allclose(got["reward_info"]["write_energy_pj"],
                                   want["reward_info"]["write_energy_pj"],
                                   rtol=1e-6)
        _assert_learned(got["committed"], want["committed"],
                        f"{msg}: committed")
        np.testing.assert_array_equal(_np(got["warm_counts"]),
                                      want["warm_counts"], err_msg=msg)
        assert_reports_close(got["warm_reports"], want["warm_reports"])


def _assert_same_run(got: dict, want: dict, msg: str) -> None:
    """Two port runs bitwise: every counter, the counts, learned indexes."""
    assert set(got["ys"]) == set(want["ys"]), msg
    for k in want["ys"]:
        assert torch.equal(got["ys"][k], want["ys"][k]), (msg, k)
    assert torch.equal(got["counts_raw"], want["counts_raw"]), msg
    assert torch.equal(got["counts"], want["counts"]), msg
    _assert_learned(got["learned"], want["learned"], msg)


# ---------------------------------------------------------------------------
# (a) one process, no group: S = 1


CASES_A = ("healthy", "traced", "dropped", "stdp", "reward")


@pytest.mark.parametrize("name", CASES_A)
def test_one_shard_matches_reference_and_compiled(cases, ref_runs, name):
    c = cases[name]
    got = run_case(_port_case(c, "sharded"))
    assert got["n_shards"] == 1 and not got["sharded"]
    assert got["exchange_bytes"] == 0          # no group: no collective
    _assert_matches_reference(got, ref_runs[name], name)
    _assert_same_run(got, run_case(_port_case(c, "compiled")), name)


# ---------------------------------------------------------------------------
# (b) the lowering against the reference's own code


def _ref_lowering(ref, n_shards):
    """The reference ShardedEngine's lowering at `n_shards`, without its
    constructor (which asks jax for that many devices)."""
    eng = object.__new__(REF_ENGINE.ShardedEngine)
    eng.sim = ref
    eng.tables = REF_ENGINE.lower_tables(ref)
    eng.n_shards = n_shards
    eng.n_domains = ENGINE.n_domains_of(ref.mapping)
    eng.plast_tables = ref.plasticity_tables()
    eng._owned = []
    eng.sharded_layers = eng._lower_shards()
    eng._plast_shards = eng._lower_plast_shards()
    return eng


@pytest.mark.parametrize("n_shards", [2, 4])
def test_lowering_matches_reference(n_shards):
    w = _weights(BOARD4, 5, 0.5)
    m, n_dom = _mapping(w, 8)
    ref = RefChipSimulator(w, mapping=m, engine="compiled",
                           quant_cfg=RefCodebookConfig(8, 8),
                           plasticity=RefPlasticityConfig(**STDP))
    want = _ref_lowering(ref, n_shards)
    port = port_from_spec(port_spec(ref), "compiled",
                          plasticity=PlasticityConfig(**STDP))
    tables = ENGINE.lower_tables(port)
    assert ENGINE.n_domains_of(port.mapping) == want.n_domains == n_dom
    empty = 0
    for s in range(n_shards):
        got = ENGINE.lower_shard(port, tables, n_shards, n_dom, s,
                                 port.plasticity_tables())
        for li, (g, r) in enumerate(zip(got, want.sharded_layers)):
            msg = f"shard {s} layer {li}"
            assert (g.width, g.words) == (r.width, r.words), msg
            np.testing.assert_array_equal(_np(g.owned), want._owned[li][s],
                                          err_msg=msg)
            for f in ("w", "nzw", "onehot"):
                np.testing.assert_array_equal(
                    _np(getattr(g, f)), np.asarray(getattr(r, f))[s],
                    err_msg=f"{msg}: {f}")
            np.testing.assert_array_equal(_np(g.pos), np.asarray(r.pos),
                                          err_msg=msg)
            cbw_s, colpos = want._plast_shards[li]
            np.testing.assert_array_equal(_np(g.cbw), np.asarray(cbw_s)[s],
                                          err_msg=f"{msg}: cbw")
            np.testing.assert_array_equal(_np(g.colpos), np.asarray(colpos),
                                          err_msg=f"{msg}: colpos")
            empty += g.owned.numel() == 0
    assert empty, "no shard without columns: the pads go untested"


# ---------------------------------------------------------------------------
# (c) invalid shard counts, and the options of the port


def test_invalid_shard_counts_rejected(cases):
    sim = port_from_spec(cases["healthy"]["spec"], "sharded")
    n_dom = sim.array_engine().n_domains
    with pytest.raises(ValueError, match="needs 1..1 devices"):
        ENGINE.ShardedEngine(sim, n_shards=n_dom + 1)
    with pytest.raises(ValueError, match="needs 1..1 devices"):
        ENGINE.ShardedEngine(sim, n_shards=0)


# ---------------------------------------------------------------------------
# (d) gloo ranks


def test_two_ranks_shard_the_cores_and_the_batch(cases, ref_runs, tmp_path):
    """World 2: S = 2 under every case of (a) against the JAX compiled
    engine; the compiled and fused engines split a batch of 4 into 2 + 2
    rows, bitwise the single-process run; every rank returns the same."""
    todo = [_port_case(cases[n], "sharded", n_shards=2) for n in CASES_A]
    split = [_port_case(cases["healthy"], "compiled"),
             _port_case(cases["quantized"], "fused"),
             _port_case(cases["stdp"], "fused")]
    ranks = spawn_ranks(tmp_path, 2, todo + split)
    for name, got in zip(CASES_A, ranks[0]):
        assert got["n_shards"] == 2 and got["sharded"], name
        assert got["exchange_bytes"] > 0, name
        _assert_matches_reference(got, ref_runs[name], f"S=2 {name}")
    for case, got in zip(split, ranks[0][len(todo):]):
        msg = f"batch-sharded {case['engine']}"
        assert got["sharded"], msg
        _assert_same_run(got, run_case(case), msg)
    for other in ranks[1:]:
        for a, b in zip(other, ranks[0]):
            _assert_same_run(a, b, "rank 1 against rank 0")


def test_four_ranks_as_a_batch_by_cores_mesh(cases, ref_runs, tmp_path):
    """World 4: S = 2 on 2 batch rows (a batch of 4 split 2 + 2; an odd
    batch of 3 run whole on both rows), STDP on that mesh, and S = 4 on a
    board of 4+ domains, against the JAX compiled engine."""
    todo = {"healthy": 2, "odd": 2, "stdp": 2, "board4": 4}
    ranks = spawn_ranks(tmp_path, 4, [
        _port_case(cases[n], "sharded", n_shards=s)
        for n, s in todo.items()])
    for (name, s), got in zip(todo.items(), ranks[0]):
        assert got["n_shards"] == s and got["sharded"], name
        _assert_matches_reference(got, ref_runs[name], f"mesh {name}")
    for other in ranks[1:]:
        for a, b in zip(other, ranks[0]):
            _assert_same_run(a, b, "rank against rank 0")


# ---------------------------------------------------------------------------
# one process, a group of one: what crosses the collectives


def test_collectives_carry_bytes_and_int64(cases, tmp_path, monkeypatch):
    """With a gloo group of one process every collective runs; it moves
    only uint8 (spike words, learned indexes, batch rows) and int64
    (counter sums), and the runs equal those without a group."""
    import torch.distributed as dist

    todo = [_port_case(cases["healthy"], "sharded"),
            _port_case(cases["stdp"], "sharded"),
            _port_case(cases["quantized"], "fused"),
            _port_case(cases["stdp"], "compiled")]
    want = [run_case(c) for c in todo]
    seen = []
    for fn in ("all_gather", "all_reduce"):
        real = getattr(dist, fn)

        def spy(*args, _real=real, **kw):
            ts = args[0] if isinstance(args[0], list) else [args[0]]
            seen.extend(t.dtype for t in ts + list(args[1:2]))
            return _real(*args, **kw)

        monkeypatch.setattr(dist, fn, spy)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        for case, w in zip(todo, want):
            got = run_case(case)
            assert got["exchange_bytes"] > 0 and not got["sharded"]
            _assert_same_run(got, w, case["engine"])
    finally:
        dist.destroy_process_group()
    assert seen and set(seen) <= {torch.uint8, torch.int64}, set(seen)
