"""The port's telemetry (`repro_torch.telemetry`, the engines' trace
counters, `core/probes.py`) against the JAX package's `repro.telemetry`,
on the CPU.

Both port engines trace the source-exactness witness net
(`source_exact_probe`, B 2, T 6, tie-free trains) and are held to the
reference's compiled-engine trace: the raw counters exactly, every
derived float64 series within 1e-12 relative, `profile`, the text
report and the Perfetto document equal; also under faults.  A disabled
`TraceConfig` issues the same aten ops as none.  The metrics registry is
held to the reference's cases.
"""
import json
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core.probes import source_exact_probe as ref_probe  # noqa: E402
from repro.faults import FaultConfig as RefFaultConfig  # noqa: E402
from repro.telemetry import TraceConfig as RefTraceConfig  # noqa: E402
from repro.telemetry import format_profile as ref_format_profile  # noqa: E402
from repro.telemetry import profile as ref_profile  # noqa: E402
from repro.telemetry import to_perfetto as ref_to_perfetto  # noqa: E402
from test_torch_harness import run_raw_ops, tie_free_trains  # noqa: E402

from repro_torch.core.probes import (source_exact_patterns,  # noqa: E402
                                     source_exact_probe)
from repro_torch.faults import FaultConfig  # noqa: E402
from repro_torch.telemetry import (ChipTrace, MetricsRegistry,  # noqa: E402
                                   TraceConfig, export_perfetto,
                                   format_profile, profile, to_perfetto)

RAW_FIELDS = ("fired", "touched", "nnz", "skip_words")
DERIVED_FIELDS = ("cycles", "core_cycles", "core_wall", "router_load",
                  "contention_cycles", "noc_hops", "noc_pj")
META_FIELDS = ("freq_hz", "zero_skip", "partial_update", "pipeline_depth",
               "layer_sizes", "slice_layer", "slice_core", "slice_neurons",
               "core_ids", "n_nodes")
ENGINES = ["compiled", "fused"]
FAULTS = dict(failed_routers=(3,), drop_p=0.05, seed=7)


def _port(engine, trace=True, faults=None):
    sim, _, _ = source_exact_probe(
        engine=engine, device="cpu",
        trace=TraceConfig(enabled=True) if trace else None,
        faults=None if faults is None else FaultConfig(**faults))
    return sim


def _witness(sim, batch=2, steps=6):
    drop = sim.compiled_engine()._drop_masks(steps)
    return tie_free_trains([w.numpy() for w in sim.weights], sim.lif,
                           (batch, steps, int(sim.weights[0].shape[0])),
                           drop=drop and [None if m is None else m.numpy()
                                          for m in drop])


@pytest.fixture(scope="module", params=[None, FAULTS],
                ids=["healthy", "faulted"])
def runs(request):
    """Per engine (sim, trace, counts, reports): the reference's compiled
    engine and both port engines, traced, on the same tie-free trains."""
    faults = request.param
    sims = {e: _port(e, faults=faults) for e in ENGINES}
    trains = _witness(sims["compiled"])
    ref, _, _ = ref_probe(engine="compiled",
                          trace=RefTraceConfig(enabled=True),
                          faults=None if faults is None
                          else RefFaultConfig(**faults))
    counts, reports = ref.run_batch(jax.numpy.asarray(trains))
    out = {"reference": (ref, ref.last_trace(), np.asarray(counts),
                         reports)}
    for engine, sim in sims.items():
        counts, reports = sim.run_batch(trains)
        out[engine] = (sim, sim.last_trace(), counts.numpy(), reports)
        assert isinstance(out[engine][1], ChipTrace)
    return out


def _assert_close(got, want, what):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _assert_close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{what}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=1e-300), \
            (what, got, want)
    else:
        assert got == want, (what, got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_trace_matches_reference(runs, engine):
    _, want, want_counts, _ = runs["reference"]
    _, got, counts, _ = runs[engine]
    np.testing.assert_array_equal(counts, want_counts)
    assert counts.sum() > 0
    for f in RAW_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in DERIVED_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=0, err_msg=f)
    for f in META_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.weight_writes is None and want.weight_writes is None


@pytest.mark.parametrize("engine", ENGINES)
def test_profile_matches_reference(runs, engine):
    ref, want, _, _ = runs["reference"]
    sim, got, _, _ = runs[engine]
    prof = profile(got, core_model=sim.core_model, riscv=sim.riscv)
    ref_prof = ref_profile(want, core_model=ref.core_model, riscv=ref.riscv)
    _assert_close(prof, ref_prof, "profile")
    assert format_profile(prof) == ref_format_profile(ref_prof)


@pytest.mark.parametrize("engine", ENGINES)
def test_perfetto_matches_reference(runs, engine, tmp_path):
    _, want, _, _ = runs["reference"]
    _, got, _, _ = runs[engine]
    for sample in range(got.batch):
        _assert_close(to_perfetto(got, sample), ref_to_perfetto(want, sample),
                      f"sample {sample}")
    text = export_perfetto(got, str(tmp_path / "trace.json"), sample=1)
    assert json.loads((tmp_path / "trace.json").read_text()) == \
        json.loads(text) == json.loads(json.dumps(to_perfetto(got, 1)))
    with pytest.raises(ValueError, match="out of range"):
        to_perfetto(got, got.batch)


@pytest.mark.parametrize("engine", ENGINES)
def test_trace_wall_matches_reports(runs, engine):
    _, trace, _, reports = runs[engine]
    walls = trace.wall_cycles()
    for b, rep in enumerate(reports):
        assert walls[b] == pytest.approx(rep.wall_cycles, rel=1e-9)


@pytest.mark.parametrize("engine", ENGINES)
def test_profile_attribution_sums_match_reports(runs, engine):
    sim, trace, _, reports = runs[engine]
    chip = profile(trace, core_model=sim.core_model, riscv=sim.riscv)
    for key, field in (("core_pj", "core_energy_pj"),
                       ("noc_pj", "noc_energy_pj"),
                       ("riscv_pj", "riscv_energy_pj"),
                       ("total_pj", "energy_pj")):
        assert chip["chip"][key] == pytest.approx(
            sum(getattr(r, field) for r in reports), rel=1e-9), key
    assert sum(row["core_pj"] for row in chip["layers"]) == pytest.approx(
        chip["chip"]["core_pj"], rel=1e-9)


def test_perfetto_round_trip_and_monotonic(runs):
    _, trace, _, _ = runs["fused"]
    doc = json.loads(json.dumps(to_perfetto(trace)))
    events = doc["traceEvents"]
    assert events
    by_track = {}
    for ev in events:
        assert ev["ph"] in ("X", "M", "C")
        if ev["ph"] == "M":
            continue
        assert ev["ts"] >= 0
        by_track.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    for track, evs in by_track.items():
        last = -1.0
        for ev in evs:
            assert ev["ts"] >= last - 1e-9, (track, ev)
            last = ev["ts"]
            if ev["ph"] == "X":
                assert ev["dur"] >= 0
    names = {ev["args"]["name"] for ev in events
             if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert any(n.startswith("core") for n in names)


@pytest.mark.parametrize("engine", ENGINES)
def test_trace_concat_batches_match_single_runs(engine):
    sim = _port(engine)
    rng = np.random.default_rng(11)
    trains = (rng.random((3, 4, 64)) < 0.25).astype(np.float32)
    sim.run_batch(trains)
    full = sim.last_trace()
    per_sample = []
    for b in range(3):
        sim.run_batch(trains[b:b + 1])
        per_sample.append(sim.last_trace())
    stitched = ChipTrace.concat(per_sample)
    stitched.validate()
    for f in RAW_FIELDS + DERIVED_FIELDS:
        np.testing.assert_array_equal(getattr(full, f), getattr(stitched, f),
                                      err_msg=f)
    assert ChipTrace.concat([full]) is full


# ---------------------------------------------------------------------------
# zero cost off


@pytest.mark.parametrize("engine", ENGINES)
def test_trace_off_issues_the_same_ops(engine):
    base = _port(engine, trace=False)
    off, _, _ = source_exact_probe(engine=engine, device="cpu",
                                   trace=TraceConfig())
    trains = (np.random.default_rng(2).random((2, 3, 64)) < 0.25).astype(
        np.float32)
    ops, ys, counts = run_raw_ops(base, trains)
    got_ops, got_ys, got_counts = run_raw_ops(off, trains)
    assert got_ops == ops
    assert (got_counts == counts).all()
    assert got_ys.keys() == ys.keys()
    for k in ys:
        assert (got_ys[k] == ys[k]).all(), k
    off.run_batch(trains)
    assert off.last_trace() is None


@pytest.mark.parametrize("engine", ENGINES)
def test_trace_adds_per_layer_counters(engine):
    """Traced runs add fired_core for every layer without a flow,
    touched_core for every layer, and (compiled) the skip-word count."""
    base = _port(engine, trace=False)
    traced = _port(engine)
    trains = np.zeros((1, 2, 64), np.float32)
    keys = set(base.array_engine().run_raw(trains)[0])
    traced_keys = set(traced.array_engine().run_raw(trains)[0])
    L = len(base.weights)
    flows = sum(ft is not None for ft in base.array_engine().tables.flows)
    extra = {f"fired_core_{li}" for li in range(flows, L)} | {
        f"touched_core_{li}" for li in range(L)}
    if engine == "compiled":
        extra.add("skip_words")
    assert traced_keys == keys | extra and not keys & extra


def test_source_exact_patterns_move_the_noc_energy():
    sim = _port("compiled", trace=False)
    srcs = [int(a.core_id) for a in sim.mapping.cores_of_layer(1)]
    dst = int(sim.mapping.cores_of_layer(2)[0].core_id)
    near, far, (near_hops, far_hops) = source_exact_patterns(sim, srcs, dst)
    assert near.sum() == far.sum() and near_hops < far_hops
    _, r_near = sim.run_batch(near)
    _, r_far = sim.run_batch(far)
    assert r_near[0].noc_energy_pj < r_far[0].noc_energy_pj


# ---------------------------------------------------------------------------
# the metrics registry (the reference's cases)


def test_metrics_registry_percentiles_and_exposition():
    reg = MetricsRegistry()
    h = reg.histogram("lat_ms", "latency")
    for v in range(1, 101):
        h.observe(float(v))
    assert h.percentile(0.5) == 50.0      # nearest-rank on 1..100
    assert h.percentile(0.95) == 95.0
    assert h.percentile(0.99) == 99.0
    c = reg.counter("reqs", "requests")
    c.inc(3)
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    with pytest.raises(TypeError):
        reg.counter("lat_ms", "wrong type")
    text = reg.expose()
    assert 'lat_ms{quantile="0.5"} 50' in text
    assert "lat_ms_count 100" in text
    assert "reqs 3" in text
    assert "depth 7" in text
    assert reg.histogram("lat_ms", "latency") is h


def test_histogram_max_samples_conflict_raises():
    reg = MetricsRegistry()
    reg.histogram("lat_ms", "latency", max_samples=128)
    with pytest.raises(ValueError, match="max_samples=128"):
        reg.histogram("lat_ms", "latency", max_samples=64)
    assert reg.histogram("lat_ms", max_samples=128).max_samples == 128


def test_help_lines_escape_backslash_and_newline():
    reg = MetricsRegistry()
    reg.counter("weird_total", "path C:\\tmp\nsecond line")
    expo = reg.expose()
    assert "# HELP weird_total path C:\\\\tmp\\nsecond line" in expo
    assert "\nsecond line" not in expo.replace("\\nsecond", "")


def test_fmt_emits_valid_inf_nan_exposition():
    reg = MetricsRegistry()
    reg.gauge("pos", "x").set(float("inf"))
    reg.gauge("neg", "x").set(float("-inf"))
    reg.gauge("nan", "x").set(float("nan"))
    lines = reg.expose().splitlines()
    assert "pos +Inf" in lines and "neg -Inf" in lines and "nan NaN" in lines
    assert not any(line.endswith(("inf", "nan", "-inf")) for line in lines)


def test_labelled_series_share_one_family_header():
    reg = MetricsRegistry()
    reg.counter("snn_requests_total", "reqs").inc(5)
    reg.counter("snn_requests_total", "reqs", {"tenant": "a"}).inc(2)
    reg.counter("snn_requests_total", "reqs", {"tenant": "b"}).inc(3)
    expo = reg.expose()
    assert expo.count("# HELP snn_requests_total") == 1
    assert expo.count("# TYPE snn_requests_total") == 1
    assert 'snn_requests_total{tenant="a"} 2' in expo
    assert 'snn_requests_total{tenant="b"} 3' in expo
    assert "snn_requests_total 5" in expo
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("snn_requests_total", "reqs", {"tenant": "c"})


def test_histogram_quantiles_window_scoped_sum_lifetime():
    reg = MetricsRegistry()
    h = reg.histogram("w_ms", "windowed", max_samples=4)
    for v in [100.0, 100.0, 100.0, 100.0, 1.0, 1.0, 1.0, 1.0]:
        h.observe(v)
    assert h.percentile(0.99) == 1.0
    assert h.count == 8 and h.sum == pytest.approx(404.0)


def test_exposition_equals_reference():
    from repro.telemetry import MetricsRegistry as RefRegistry

    def fill(reg):
        h = reg.histogram("lat_ms", "latency", max_samples=16)
        for v in range(40):
            h.observe(v * 0.37)
        reg.counter("reqs_total", "reqs", {"tenant": "a"}).inc(4)
        reg.gauge("depth", "queue\\depth").set(-2.5)
        return reg.expose()

    assert fill(MetricsRegistry()) == fill(RefRegistry())
