"""Whole runs of the port's on-chip plasticity against the JAX package's,
on the CPU (split from tests/test_torch_plasticity.py, whose fixtures it
shares through tests/test_torch_harness.py: SIZES 64-96-96-16, an 8-level
8-bit codebook, lr 0.4, B 1 and 4, T 6).

The port's compiled, fused and reference engines against the same engine
of the reference: spikes, learned indexes and `weight_writes` equal,
report fields within 1e-6; warm starts (broadcast and per-sample), the
scalar and vector reward commit, indexes outside the codebook, odd
widths, and a codebook fault in the initial indexes.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import plasticity as REF_PLC  # noqa: E402
from repro.core.quant import CodebookConfig as RefCodebookConfig  # noqa: E402
from repro.core.soc import ChipSimulator as RefChipSimulator  # noqa: E402
from test_torch_harness import (  # noqa: E402
    PLASTIC_ENGINES as ENGINES, PLASTIC_SIZES as SIZES,
    assert_learned_equal as _assert_learned_equal,
    assert_plastic_runs_equal as _assert_runs_equal,
    plastic_faults as _faults, plastic_pair as _pair,
    plastic_port_sim as _port_sim, plastic_run as _run,
    plastic_trains as _trains, plastic_weights as _weights,
    port_from_reference)

from repro_torch import PlasticityConfig  # noqa: E402


# ---------------------------------------------------------------------------
# whole runs against the reference


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("batch", [1, 4])
def test_stdp_run_matches_reference(engine, batch):
    ref, port = _pair("stdp", engine)
    trains = _trains(batch=batch)
    got, want = _run(port, trains), _run(ref, trains)
    _assert_runs_equal(got, want, f"stdp/{engine}/B{batch}")
    assert sum(r.stats.weight_writes for r in got[1]) > 0
    assert sum(r.write_energy_pj for r in got[1]) > 0
    for got_t, want_t in zip(port.plasticity_tables(),
                             ref.plasticity_tables()):
        assert (got_t is None) == (want_t is None)
        if want_t is not None:
            _assert_learned_equal(got_t, want_t)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_reward_run_and_commit_match_reference(engine, kind):
    ref, port = _pair("reward", engine)
    trains = _trains()
    got, want = _run(port, trains), _run(ref, trains)
    _assert_runs_equal(got, want, f"reward/{engine}")
    # in-trial: eligibility only, zero register writes
    assert all(r.stats.weight_writes == 0 for r in got[1])
    if kind == "scalar":
        reward = 1.0
    else:
        reward = np.zeros(SIZES[-1], np.float32)
        reward[3], reward[7] = 1.0, -1.0
    info_g, info_w = port.apply_reward(reward), ref.apply_reward(reward)
    np.testing.assert_array_equal(info_g["weight_writes"],
                                  np.asarray(info_w["weight_writes"]))
    np.testing.assert_allclose(info_g["write_energy_pj"],
                               info_w["write_energy_pj"], rtol=1e-6)
    np.testing.assert_array_equal(info_g["write_cycles"],
                                  np.asarray(info_w["write_cycles"]))
    assert info_g["weight_writes"].sum() > 0
    _assert_learned_equal(port.last_learned, ref.last_learned,
                          f"reward/{engine}: committed indexes")
    # the committed indexes warm-start the next trial
    _assert_runs_equal(_run(port, trains, port.last_learned),
                       _run(ref, trains, ref.last_learned),
                       f"reward/{engine}: warm")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("form", ["broadcast", "per-sample"])
def test_warm_start_matches_reference(engine, form):
    ref, port = _pair("stdp", engine)
    trains = _trains()
    _run(ref, trains)
    learned = [None if l is None else np.asarray(l) for l in ref.last_learned]
    if form == "broadcast":
        learned = [None if l is None else l[1] for l in learned]
    _assert_runs_equal(_run(port, trains, learned),
                       _run(ref, trains, learned), f"warm/{engine}/{form}")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("rule", ["stdp", "reward"])
def test_out_of_range_learned_matches_reference(engine, rule):
    """Caller-given indexes -1, 8 and 100 in layer 2 (L = 8) run as the
    JAX engines run them: read by JAX's gather rule, then learned."""
    ref, port = _pair(rule, engine)
    idx = np.array(ref.plasticity_tables()[2][0], np.int8)
    idx[0, :3] = (-1, 8, 100)
    idx[5, 7], idx[17, 2] = 100, -1
    learned = [None, None, idx]
    trains = _trains()
    got, want = _run(port, trains, learned), _run(ref, trains, learned)
    _assert_runs_equal(got, want, f"{rule}/{engine}")
    if rule == "reward":
        info_g, info_w = port.apply_reward(1.0), ref.apply_reward(1.0)
        np.testing.assert_array_equal(info_g["weight_writes"],
                                      np.asarray(info_w["weight_writes"]))
        _assert_learned_equal(port.last_learned, ref.last_learned,
                              f"{rule}/{engine}: committed")


ODD_SIZES = [50, 40, 24, 10]      # no width a multiple of 16


def _odd_pair(rule, engine):
    cfg = (dict(enabled=True, mode="stdp", lr=0.4) if rule == "stdp" else
           dict(enabled=True, mode="reward", lr=0.4, elig_pre=0.1,
                layers=(0, 1)))
    ref = RefChipSimulator(_weights(ODD_SIZES, seed=3), engine=engine,
                           quant_cfg=RefCodebookConfig(8, 8),
                           plasticity=REF_PLC.PlasticityConfig(**cfg))
    port = port_from_reference(ref, engine=engine,
                               plasticity=PlasticityConfig(**cfg))
    return ref, port


@pytest.mark.parametrize("engine", ENGINES)
def test_odd_widths_learn_as_reference(engine):
    """50-40-24-10: STDP on every layer, then R-STDP on layers 0-1 with a
    commit and a warm start, on rows the fused engine pads and crops."""
    rng = np.random.default_rng(4)
    trains = np.asarray(rng.random((3, 6, ODD_SIZES[0])) < 0.3, np.float32)
    ref, port = _odd_pair("stdp", engine)
    got, want = _run(port, trains), _run(ref, trains)
    _assert_runs_equal(got, want, f"odd stdp/{engine}")
    assert sum(r.stats.weight_writes for r in got[1]) > 0
    ref, port = _odd_pair("reward", engine)
    _assert_runs_equal(_run(port, trains), _run(ref, trains),
                       f"odd reward/{engine}")
    info_g, info_w = port.apply_reward(1.0), ref.apply_reward(1.0)
    np.testing.assert_array_equal(info_g["weight_writes"],
                                  np.asarray(info_w["weight_writes"]))
    assert info_g["weight_writes"].sum() > 0
    _assert_runs_equal(_run(port, trains, port.last_learned),
                       _run(ref, trains, ref.last_learned),
                       f"odd reward/{engine}: warm")


@pytest.mark.parametrize("engine", ENGINES)
def test_faulted_plasticity_matches_reference(engine):
    ref, port = _pair("stdp", engine, faulted=True)
    _assert_runs_equal(_run(port, _trains()), _run(ref, _trains()),
                       f"fault+stdp/{engine}")


def test_codebook_fault_corrupts_initial_plasticity_tables():
    clean = _port_sim("compiled", "stdp")
    faulty = _port_sim("compiled", "stdp", mapping=clean.mapping,
                       faults=_faults(True))
    pt_c, pt_f = clean.plasticity_tables(), faulty.plasticity_tables()
    # the fault reprograms codebook words => the plasticity lowering
    # (which runs AFTER fault application) must see the corrupted levels
    assert any(a is not None and not torch.equal(a[1], b[1])
               for a, b in zip(pt_c, pt_f))
    trains = _trains()
    c_clean, _ = clean.run_batch(trains)
    c_fault, _ = faulty.run_batch(trains)
    assert not torch.equal(c_clean, c_fault)
    assert any(a is not None and not torch.equal(a, b)
               for a, b in zip(clean.last_learned, faulty.last_learned))
