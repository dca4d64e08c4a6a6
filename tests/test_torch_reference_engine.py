"""The port's interpretive engine, `ChipSimulator(engine="reference")`,
against the JAX package's, on the CPU: healthy, faulted with a drop plan,
traced (raw counters equal, every derived series within 1e-9 relative),
and against the port's own compiled engine; plus the scalar cycle model
(`CycleModel.stage_cycles` / `timestep_cycles(writes=)`) against the
reference's.  Whole runs use tie-free trains: output counts and integer
stats equal, `ChipReport` fields within 1e-6 relative.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core.quant import CodebookConfig as RefCodebookConfig  # noqa: E402
from repro.core.soc import ChipSimulator as RefChipSimulator  # noqa: E402
from repro.core.zspe import CoreGeometry as RefCoreGeometry  # noqa: E402
from repro.core.zspe import CycleModel as RefCycleModel  # noqa: E402
from repro.faults import FaultConfig as RefFaultConfig  # noqa: E402
from repro.telemetry import TraceConfig as RefTraceConfig  # noqa: E402
from test_torch_harness import (assert_reports_close,  # noqa: E402
                                port_from_reference, tie_free_trains)

from repro_torch import ChipSimulator  # noqa: E402
from repro_torch.core.zspe import CoreGeometry, CycleModel  # noqa: E402
from repro_torch.faults import FaultConfig, TransientChipFault  # noqa: E402
from repro_torch.kernels import fused_timestep as FT  # noqa: E402
from repro_torch.telemetry import TraceConfig  # noqa: E402

SIZES = [64, 96, 96, 16]
BATCH, STEPS = 3, 6
# (FaultConfig fields, quantized): a healthy float and quantized chip, and
# a faulted one of each — dead core, failed router and a per-hop drop
CHIPS = {
    "healthy-float": (None, False),
    "healthy-quantized": (None, True),
    "faulted-float": (dict(dead_cores=(14,), failed_routers=(3,),
                           drop_p=0.15, seed=7), False),
    "faulted-quantized": (dict(dead_cores=(30,), failed_links=((0, 12),),
                               drop_p=0.05, seed=3), True),
}
DERIVED = ("cycles", "core_cycles", "core_wall", "router_load",
           "contention_cycles", "noc_hops", "noc_pj")
RAW = ("fired", "touched", "nnz", "skip_words")


def _weights(sizes=SIZES, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, scale / np.sqrt(a), (a, b)).astype(np.float32)
            for a, b in zip(sizes[:-1], sizes[1:])]


def _sims(name, traced=False):
    """(reference engine of the JAX package, the port's of the same chip,
    tie-free trains for it)."""
    fields, quantized = CHIPS[name]
    ref = RefChipSimulator(
        [jax.numpy.asarray(w) for w in _weights()], engine="reference",
        quant_cfg=RefCodebookConfig(8, 8, zero_level=True) if quantized
        else None,
        faults=None if fields is None else RefFaultConfig(**fields),
        trace=RefTraceConfig(enabled=True) if traced else None)
    port = port_from_reference(
        ref, engine="reference",
        faults=None if fields is None else FaultConfig(**fields),
        trace=TraceConfig(enabled=True) if traced else None,
        weights=_weights())
    drop = port.compiled_engine()._drop_masks(STEPS)
    trains = tie_free_trains(
        [w.numpy() for w in port.weights], port.lif,
        (BATCH, STEPS, SIZES[0]),
        drop=drop and [None if m is None else m.numpy() for m in drop])
    return ref, port, trains


@pytest.fixture(scope="module", params=list(CHIPS))
def chip(request):
    return request.param, _sims(request.param, traced=True)


def _assert_trace_close(got, want, rel=1e-9):
    for f in RAW:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)
    for f in DERIVED:
        np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(want, f)),
                                   rtol=rel, atol=0, err_msg=f)


def test_reference_engine_matches_jax(chip):
    name, (ref, port, trains) = chip
    counts, reports = port.run_batch(trains)
    rcounts, rreports = ref.run_batch(jax.numpy.asarray(trains))
    assert counts.shape == (BATCH, SIZES[-1])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    assert_reports_close(reports, rreports)
    assert [r.stats.weight_writes for r in reports] == [0.0] * BATCH
    if CHIPS[name][0] is not None:
        assert port.drop_plan is not None
    _assert_trace_close(port.last_trace(), ref.last_trace())
    assert port.last_trace().batch == BATCH


def test_reference_engine_matches_port_compiled(chip):
    name, (_, port, trains) = chip
    comp = ChipSimulator(
        port.qweights if port.qweights is not None else _weights(),
        engine="compiled", mapping=port.mapping, device="cpu",
        faults=port.faults, trace=TraceConfig(enabled=True))
    counts, reports = port.run_batch(trains)
    ccounts, creports = comp.run_batch(trains)
    assert torch.equal(counts, ccounts)
    assert_reports_close(reports, creports)
    _assert_trace_close(port.last_trace(), comp.last_trace())


def test_trace_sums_match_reports(chip):
    _, (_, port, trains) = chip
    _, reports = port.run_batch(trains)
    np.testing.assert_allclose(port.last_trace().wall_cycles(),
                               [r.wall_cycles for r in reports], rtol=1e-12)


def test_untraced_run_leaves_no_trace():
    ref, port, trains = _sims("faulted-float")
    counts, reports = port.run_batch(trains)
    rcounts, rreports = ref.run_batch(jax.numpy.asarray(trains))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    assert_reports_close(reports, rreports)
    assert port.last_trace() is None


def test_run_is_one_sample_of_run_batch():
    _, port, trains = _sims("healthy-quantized")
    counts, report = port.run(trains[1])
    batch_counts, reports = port.run_batch(trains)
    assert torch.equal(counts, batch_counts[1])
    assert dataclasses.astuple(report) == dataclasses.astuple(reports[1])


def test_reference_engine_launches_no_kernel():
    _, port, trains = _sims("healthy-quantized")
    before = dict(FT.launches)
    port.run_batch(trains)
    assert FT.launches == before
    with pytest.raises(ValueError, match="interpretive"):
        port.array_engine()


def test_transient_fault_raises_then_clears():
    sim = ChipSimulator(_weights(), engine="reference", device="cpu",
                        faults=FaultConfig(transient_dispatches=(0,)))
    trains = (np.random.default_rng(0).random((2, 3, SIZES[0]))
              < 0.25).astype(np.float32)
    with pytest.raises(TransientChipFault, match="dispatch 0"):
        sim.run_batch(trains)
    counts, _ = sim.run_batch(trains)
    clean, _ = ChipSimulator(_weights(), engine="reference", device="cpu",
                             mapping=sim.mapping).run_batch(trains)
    assert torch.equal(counts, clean)


# ---------------------------------------------------------------------------
# the scalar cycle model


@pytest.mark.parametrize("zero_skip,partial_update",
                         list(itertools.product([True, False], repeat=2)))
def test_scalar_cycles_match_reference(zero_skip, partial_update):
    got, want = CycleModel(), RefCycleModel()
    assert dataclasses.asdict(got.geom) == dataclasses.asdict(want.geom)
    for n_pre, n_post, nnz, touched, writes in itertools.product(
            (1, 16, 17, 2312), (1, 10, 1024), (0.0, 3.0, 231.0),
            (0.0, 5.0, 1024.0), (None, 0.0, 7.0, 4096.0)):
        args = (n_pre, n_post, nnz, touched, zero_skip, partial_update)
        assert got.stage_cycles(*args) == want.stage_cycles(*args)
        g = got.timestep_cycles(*args, writes=writes)
        assert g == want.timestep_cycles(*args, writes=writes)
        assert isinstance(g, int)


def test_array_cycles_writes_term_matches_scalar():
    geom = CoreGeometry(write_lanes=8)
    got, want = CycleModel(geom), RefCycleModel(RefCoreGeometry(write_lanes=8))
    slices = torch.tensor([[100.0, 37.0, 1.0]])
    nnz = torch.tensor([[3.0], [40.0]])
    touched = torch.tensor([[5.0, 37.0, 0.0], [100.0, 2.0, 1.0]])
    writes = torch.tensor([[0.0, 9.0, 2000.0], [17.0, 0.0, 1.0]])
    arr = got.timestep_cycles_array(64, slices, nnz, touched, writes=writes)
    for b, a in itertools.product(range(2), range(3)):
        assert float(arr[b, a]) == want.timestep_cycles(
            64, int(slices[0, a]), float(nnz[b, 0]), float(touched[b, a]),
            writes=float(writes[b, a]))
    assert torch.equal(
        got.timestep_cycles_array(64, slices, nnz, touched),
        got.timestep_cycles_array(64, slices, nnz, touched, writes=None))


@pytest.mark.parametrize("engine", ["reference", "compiled", "fused"])
def test_traced_plasticity_matches_jax(engine):
    """STDP traced, on the reference suite's fixture: the trace's write
    series against the JAX package's and summing to the reports'."""
    from repro.core.plasticity import PlasticityConfig as RefPlasticity

    from repro_torch import PlasticityConfig

    rng = np.random.default_rng(0)
    ws = [np.asarray(rng.normal(0, 1.2 / np.sqrt(a), (a, b)), np.float32)
          for a, b in zip(SIZES[:-1], SIZES[1:])]
    trains = (np.random.default_rng(1).random((2, STEPS, SIZES[0]))
              < 0.25).astype(np.float32)
    ref = RefChipSimulator(ws, engine=engine, quant_cfg=RefCodebookConfig(8, 8),
                           trace=RefTraceConfig(enabled=True),
                           plasticity=RefPlasticity(enabled=True, lr=0.4))
    port = port_from_reference(ref, engine=engine,
                               trace=TraceConfig(enabled=True),
                               plasticity=PlasticityConfig(enabled=True,
                                                           lr=0.4))
    counts, reports = port.run_batch(trains)
    rcounts, rreports = ref.run_batch(jax.numpy.asarray(trains))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    trace, rtrace = port.last_trace(), ref.last_trace()
    np.testing.assert_array_equal(trace.weight_writes,
                                  np.asarray(rtrace.weight_writes))
    np.testing.assert_array_equal(trace.weight_writes.sum(axis=(1, 2)),
                                  [r.stats.weight_writes for r in reports])
    assert trace.weight_writes.sum() > 0
    for f in DERIVED:
        np.testing.assert_allclose(getattr(trace, f),
                                   np.asarray(getattr(rtrace, f)),
                                   rtol=1e-9, atol=0, err_msg=f)


@pytest.mark.parametrize("rule", ["stdp", "reward"])
def test_reference_engine_is_compiled_one_sample_at_a_time(rule):
    """Inside the port: the interpretive engine issues the compiled
    engine's layer-step for a batch of one, so a sample's spikes, learned
    indexes, eligibility and writes are bitwise those of the compiled
    engine run on that sample alone."""
    from repro_torch import CodebookConfig, PlasticityConfig

    cfg = (PlasticityConfig(enabled=True, lr=0.4) if rule == "stdp" else
           PlasticityConfig(enabled=True, mode="reward", lr=0.4,
                            elig_pre=0.1, layers=(2,)))
    ref = ChipSimulator(_weights(scale=1.2), engine="reference",
                        device="cpu", quant_cfg=CodebookConfig(8, 8),
                        plasticity=cfg, trace=TraceConfig(enabled=True))
    comp = ChipSimulator(_weights(scale=1.2), engine="compiled",
                         device="cpu", quant_cfg=CodebookConfig(8, 8),
                         mapping=ref.mapping, plasticity=cfg)
    trains = (np.random.default_rng(1).random((BATCH, STEPS, SIZES[0]))
              < 0.25).astype(np.float32)
    counts, reports = ref.run_batch(trains)
    trace = ref.last_trace()
    eligs = ref._ref_elig
    for b in range(BATCH):
        ys, c = comp.compiled_engine().run_raw(trains[b:b + 1])
        assert torch.equal(c[0], counts[b])
        np.testing.assert_array_equal(ys["writes"][0].numpy(),
                                      trace.weight_writes[b])
        for li, learned in enumerate(ref.last_learned):
            if learned is None:
                assert f"learned_idx_{li}" not in ys
                continue
            assert torch.equal(ys[f"learned_idx_{li}"][0], learned[b])
            if rule == "reward":
                assert torch.equal(ys[f"elig_{li}"][0], eligs[li][b])
    assert (sum(r.stats.weight_writes for r in reports) > 0) == \
        (rule == "stdp")
