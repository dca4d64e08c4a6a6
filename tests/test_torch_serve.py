"""The port's SNN serving tier (`repro_torch.serve`: `SnnServer`,
admission, resilience, and the host DMA model of `core/soc.py`) against
the JAX package's `repro.serve`, on the CPU.

Every scenario of the reference's serving suites (tests/test_serve.py,
tests/test_admission_properties.py, tests/test_engine_equiv.py's server
tests and tests/test_telemetry.py's server test) runs twice: through the
JAX `SnnServer` on a reference simulator, and through the port's on the
port's simulator of the same network (`port_from_reference`), with the
same requests and the same `FakeClock` script.  Networks are 64-96-96-16
with an 8-level 8-bit codebook, T <= 8, and the trains are tie-free for
every network they reach (`tie_free_trains`), so:

* statuses, predictions, spike counts, swap counts and the retry /
  fault / degraded counters are equal;
* `energy_pj` and `pj_per_sop` agree within `REPORT_REL` (1e-6), and the
  DMA prices, which are host arithmetic on equal register tables, exactly;
* `RetryPolicy.delay_s` is equal to the float;
* the metrics registries hold the same series: counter values and
  histogram counts equal, energy sums within 1e-6.

`engine="reference"` is rejected with the reference's message, as the
JAX `Tenant` rejects it.
"""
import math
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st  # noqa: E402
from repro.core import noc as REF_NOC  # noqa: E402
from repro.core import soc as REF_SOC  # noqa: E402
from repro.core.quant import CodebookConfig as RefCodebookConfig  # noqa: E402
from repro.faults import FaultConfig as RefFaultConfig  # noqa: E402
from repro.faults import TransientChipFault as RefTransient  # noqa: E402
from repro.serve import admission as REF_ADM  # noqa: E402
from repro.serve import resilience as REF_RES  # noqa: E402
from repro.serve import snn_server as REF_SRV  # noqa: E402
from test_torch_harness import (REPORT_REL, min_tie_margin,  # noqa: E402
                                port_from_reference)

from repro_torch.core import noc as NOC  # noqa: E402
from repro_torch.core import soc as SOC  # noqa: E402
from repro_torch.faults import FaultConfig, TransientChipFault  # noqa: E402
from repro_torch.serve import admission as ADM  # noqa: E402
from repro_torch.serve import resilience as RES  # noqa: E402
from repro_torch.serve import snn_server as SRV  # noqa: E402

SIZES = [64, 96, 96, 16]          # widths stay multiples of 16 (fused pack)
STEPS = 6
N_IN = SIZES[0]

REF = types.SimpleNamespace(
    name="ref", i=0, Server=REF_SRV.SnnServer, Request=REF_ADM.SnnRequest,
    Retry=REF_RES.RetryPolicy, Dma=REF_SOC.HostDmaModel,
    Transient=RefTransient, CircuitOpen=REF_RES.CircuitOpenError,
    Timeout=REF_RES.DispatchTimeout, adm=REF_ADM, soc=REF_SOC,
    arr=jax.numpy.asarray)
PORT = types.SimpleNamespace(
    name="port", i=1, Server=SRV.SnnServer, Request=ADM.SnnRequest,
    Retry=RES.RetryPolicy, Dma=SOC.HostDmaModel,
    Transient=TransientChipFault, CircuitOpen=RES.CircuitOpenError,
    Timeout=RES.DispatchTimeout, adm=ADM, soc=SOC,
    arr=lambda x: torch.as_tensor(np.asarray(x)))
SIDES = (REF, PORT)


class FakeClock:
    """Injectable monotonic clock for deterministic deadline tests."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def advance(self, dt: float) -> None:
        self.t += float(dt)

    def __call__(self) -> float:
        return self.t


def _weights(seed):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.normal(0, 1.2 / np.sqrt(a), (a, b)), np.float32)
            for a, b in zip(SIZES[:-1], SIZES[1:])]


def _pair(seed=0, engine="compiled", mapping=None, strategy="anneal",
          transient=None):
    """(reference simulator, the port's of the same network): weights
    from `seed`, 8-level quantized by the reference, `transient` the
    dispatch indexes of an injected `TransientChipFault`."""
    faults = (None if transient is None
              else RefFaultConfig(transient_dispatches=tuple(transient)))
    ref = REF_SOC.ChipSimulator(_weights(seed), engine=engine,
                                quant_cfg=RefCodebookConfig(8, 8),
                                mapping=mapping, mapping_strategy=strategy,
                                faults=faults)
    port = port_from_reference(
        ref, engine=engine, faults=None if transient is None
        else FaultConfig(transient_dispatches=tuple(transient)))
    return ref, port


def _train_pool(seeds=(0,), n=8, T=STEPS, density=0.25):
    """`n` (T, 64) trains, tie-free on every network of `seeds` (each
    train alone, as a request of a padded slot group runs)."""
    ws = [[np.asarray(w) for w in _pair(s)[0].weights] for s in seeds]
    lif = _pair(seeds[0])[0].lif
    for trial in range(50):
        rng = np.random.default_rng(500 + trial)
        trains = (rng.random((n, T, N_IN)) < density).astype(np.float32)
        if all(min_tie_margin(w, lif, trains) > 1e-5 for w in ws):
            return list(trains)
    raise RuntimeError("no tie-free fixture found")


def _outcome(reqs):
    return [(r.uid, r.status, r.prediction,
             None if r.spike_counts is None
             else np.asarray(r.spike_counts, np.float32),
             r.energy_pj, r.pj_per_sop, r.dma_pj, r.degraded,
             r.t_enqueue, r.t_dequeue, r.t_complete, r.deadline)
            for r in reqs]


def _assert_outcomes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3], (g[:3], w[:3])
        if w[3] is None:
            assert g[3] is None
        else:
            np.testing.assert_array_equal(g[3], w[3], err_msg=str(w[0]))
        for a, b in zip(g[4:6], w[4:6]):
            assert abs(a - b) <= REPORT_REL * max(abs(b), 1.0), (w[0], a, b)
        assert g[6:] == w[6:], (g[6:], w[6:])


def _assert_metrics_equal(got, want):
    """Both registries as `to_dict()`: the same series, counters and
    gauges equal (energy totals within 1e-6), histogram counts equal and
    sums / quantiles within 1e-6."""
    g, w = got.metrics.to_dict(), want.metrics.to_dict()
    assert sorted(g) == sorted(w)
    for key, wv in w.items():
        gv = g[key]
        if isinstance(wv, dict):
            assert gv["count"] == wv["count"], key
            for q, b in wv.items():
                a = gv[q]
                assert (a is None) == (b is None), (key, q)
                if b is not None:
                    assert a == pytest.approx(b, rel=REPORT_REL), (key, q)
        else:
            assert gv == pytest.approx(wv, rel=REPORT_REL), key
    assert got.host_summary() == pytest.approx(want.host_summary(),
                                               rel=1e-12)


def _counters(srv):
    return (srv._m_faults.value, srv._m_retries.value,
            srv._m_degraded.value, srv._m_swaps.value)


def _both(scenario, sims, *args):
    """Run `scenario(side, sims, *args)` for the reference and the port:
    `sims` a (reference, port) pair, or a list of pairs (the side's sim of
    each); returns their (server, outcome, ...) tuples."""
    return [scenario(side, [s[side.i] for s in sims]
                     if isinstance(sims, list) else sims[side.i], *args)
            for side in SIDES]


def _assert_runs_equal(runs):
    (srv_r, out_r, *_), (srv_p, out_p, *_) = runs
    _assert_outcomes_equal(out_p, out_r)
    _assert_metrics_equal(srv_p, srv_r)
    assert _counters(srv_p) == _counters(srv_r)


# ---------------------------------------------------------------------------
# submit-time validation


@pytest.mark.parametrize("events,match", [
    (np.zeros((0, N_IN), np.float32), "T >= 1"),
    ("non-binary", "binary"),
    (np.zeros((4, N_IN + 1), np.float32), r"\(T, 64\)"),
], ids=["zero-T", "non-binary", "width"])
def test_submit_rejects_bad_trains_as_reference(events, match):
    if isinstance(events, str):
        events = np.zeros((4, N_IN), np.float32)
        events[1, 3] = 0.7
    msgs = []
    for side, sim in zip(SIDES, _pair()):
        srv = side.Server(sim, batch_slots=2)
        with pytest.raises(ValueError, match=match) as e:
            srv.submit(side.Request(uid=0, events=events))
        assert srv.queue == []
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_submit_rejects_unknown_model_as_reference():
    msgs = []
    for side, sim in zip(SIDES, _pair()):
        srv = side.Server(sim, batch_slots=2)
        with pytest.raises(ValueError, match="unknown model") as e:
            srv.submit(side.Request(uid=1, events=np.zeros((4, N_IN)),
                                    model="nope"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_validate_events_casts_to_f32_binary():
    for side in SIDES:
        ev = side.adm.validate_events(np.ones((3, 8), np.int64), 8, uid=7)
        assert ev.dtype == np.float32 and ev.shape == (3, 8)


def test_reference_engine_rejected_as_reference():
    """9a: the JAX `Tenant` takes only the array engines; so does the
    port's, with the same message, for a primary and a degraded sim."""
    ref, port = _pair(engine="reference")
    msgs = []
    for side, sim in ((REF, ref), (PORT, port)):
        with pytest.raises(ValueError) as e:
            side.Server(sim, batch_slots=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "engine='compiled' or 'fused'" in msgs[1]
    good = _pair()
    msgs = []
    for side, sim, bad in ((REF, good[0], ref), (PORT, good[1], port)):
        srv = side.Server(None, batch_slots=2)
        with pytest.raises(ValueError) as e:
            srv.add_model("default", sim, degraded_sim=bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# transactional dispatch under engine faults


def _engine_fault(side, sim, trains):
    clock = FakeClock()
    srv = side.Server(sim, batch_slots=4, clock=clock)
    reqs = [srv.submit(side.Request(uid=i, events=trains[i]))
            for i in range(3)]
    real_run_batch = srv.sim.run_batch

    def boom(batch):
        raise RuntimeError("injected engine fault")

    srv.tenants["default"].sim.run_batch = boom
    with pytest.raises(RuntimeError, match="injected engine fault"):
        srv.step()
    assert [r.status for r in reqs] == ["queued"] * 3
    assert all(r.t_dequeue is None for r in reqs)
    assert len(srv.queue) == 3
    assert srv.metrics.get("snn_queue_depth").value == 3
    assert srv.metrics.get("snn_batch_occupancy").count == 0
    assert srv.metrics.get("snn_requests_served_total").value == 0
    srv.tenants["default"].sim.run_batch = real_run_batch
    clock.advance(0.002)
    done = srv.run()
    assert [r.status for r in done] == ["served"] * 3
    assert srv.metrics.get("snn_batch_occupancy").count == 1
    return srv, _outcome(reqs)


def test_engine_fault_leaves_server_state_untouched():
    _assert_runs_equal(_both(_engine_fault, _pair(), _train_pool()))


# ---------------------------------------------------------------------------
# deadline / shed semantics


def _expired(side, sim, trains):
    clock = FakeClock()
    srv = side.Server(sim, batch_slots=4, clock=clock)
    r = srv.submit(side.Request(uid=0, events=trains[0], deadline_ms=10.0))
    assert r.status == "queued" and r.deadline == pytest.approx(0.010)
    clock.advance(0.050)
    srv.tenants["default"].sim.run_batch = lambda b: (_ for _ in ()).throw(
        AssertionError("expired request must not reach the engine"))
    done = srv.step()
    assert [x.status for x in done] == ["deadline_exceeded"]
    assert r.prediction is None and r.t_complete == clock.t
    assert srv.queue == []
    assert srv.metrics.get("snn_queue_depth").value == 0
    assert srv.metrics.get("snn_requests_deadline_exceeded_total").value == 1
    return srv, _outcome([r])


def test_expired_request_completes_without_engine_launch():
    _assert_runs_equal(_both(_expired, _pair(), _train_pool()))


def _shed(side, sim, trains):
    srv = side.Server(sim, batch_slots=2, max_queue_depth=2,
                      clock=FakeClock())
    reqs = [srv.submit(side.Request(uid=i, events=trains[i]))
            for i in range(3)]
    assert [r.status for r in reqs] == ["queued", "queued", "shed"]
    assert reqs[2].t_complete is not None and len(srv.queue) == 2
    assert srv.metrics.get("snn_queue_depth").value == 2
    assert srv.metrics.get("snn_requests_shed_total").value == 1
    assert srv.metrics.get(
        "snn_requests_shed_total", {"tenant": "default"}).value == 1
    done = srv.run()
    assert {r.uid for r in done} == {0, 1}
    return srv, _outcome(reqs)


def test_bounded_queue_sheds_explicitly_with_exact_gauge():
    _assert_runs_equal(_both(_shed, _pair(), _train_pool()))


def _deadline_order(side, sim, trains):
    clock = FakeClock()
    srv = side.Server(sim, batch_slots=2, clock=clock)
    srv.submit(side.Request(uid=0, events=trains[0], deadline_ms=500.0))
    clock.advance(0.001)
    srv.submit(side.Request(uid=1, events=trains[1], deadline_ms=50.0))
    clock.advance(0.001)
    srv.submit(side.Request(uid=2, events=trains[2]))
    group = side.adm.form_group(srv.queue, slots=2, now=clock.t)
    assert [r.uid for r in group] == [1, 0]
    clock.advance(0.001)
    done = srv.run()
    assert [r.uid for r in done] == [1, 0, 2]
    return srv, _outcome(done)


def test_group_formation_is_oldest_deadline_first():
    _assert_runs_equal(_both(_deadline_order, _pair(), _train_pool()))


# ---------------------------------------------------------------------------
# continuous-batching liveness


def _late_join(side, sim, trains):
    clock = FakeClock()
    srv = side.Server(sim, batch_slots=4, clock=clock)
    reqs = [srv.submit(side.Request(uid=i, events=trains[i]))
            for i in range(6)]
    clock.advance(0.001)
    first = srv.step()
    assert len(first) == 4 and len(srv.queue) == 2
    late = srv.submit(side.Request(uid=99, events=trains[6]))
    clock.advance(0.003)
    second = srv.step()
    assert late in second and {r.uid for r in second} == {4, 5, 99}
    assert late.t_dequeue == second[0].t_dequeue and srv.queue == []
    return srv, _outcome(reqs + [late])


def test_late_request_joins_next_group_not_full_drain():
    _assert_runs_equal(_both(_late_join, _pair(), _train_pool()))


# ---------------------------------------------------------------------------
# multi-model tenancy


def _disjoint_sims():
    """Tenant a greedy-mapped; tenant b's greedy mapping remapped by the
    reference onto the last free cores.  The port's `remap_mapping_cores`
    must give the same mapping."""
    ref_a, port_a = _pair(10, strategy="greedy")
    ref_b0, port_b0 = _pair(11, strategy="greedy")
    used = set(ref_a.mapping.active_core_ids())
    pool = [int(c) for c in REF_NOC.core_ids() if int(c) not in used]
    n_b = len(ref_b0.mapping.active_core_ids())
    ref_map = REF_SOC.remap_mapping_cores(ref_b0.mapping, pool[-n_b:])
    port_pool = [int(c) for c in NOC.core_ids()
                 if int(c) not in set(port_a.mapping.active_core_ids())]
    port_map = SOC.remap_mapping_cores(port_b0.mapping, port_pool[-n_b:])
    assert [tuple(vars(a).values()) for a in port_map.assignments] == \
        [tuple(vars(a).values()) for a in ref_map.assignments]
    ref_b, port_b = _pair(11, mapping=ref_map)
    return (ref_a, port_a), (ref_b, port_b)


def _multi_tenant(side, sims, trains):
    sim_a, sim_b = sims
    multi = side.Server(sim_a, batch_slots=4, clock=FakeClock())
    tb = multi.add_model("b", sim_b)
    assert not (multi.tenants["default"].core_ids & tb.core_ids)
    reqs = [multi.submit(side.Request(uid=i, events=ev,
                                      model="b" if i % 2 else "default"))
            for i, ev in enumerate(trains[:6])]
    multi.run()
    hs = multi.host_summary()
    assert hs["model_swaps"] == 2 and hs["swap_pj"] > 0
    return multi, _outcome(reqs)


def test_multi_tenant_disjoint_cores_equal_to_solo_and_reference():
    sims = _disjoint_sims()
    trains = _train_pool(seeds=(10, 11))
    runs = _both(_multi_tenant, list(sims), trains)
    _assert_runs_equal(runs)
    # the port's interleaved tenants equal two solo port servers
    (sim_a, sim_b) = (sims[0][1], sims[1][1])
    solo_a = SRV.SnnServer(sim_a, batch_slots=4, clock=FakeClock())
    solo_b = SRV.SnnServer(sim_b, batch_slots=4, clock=FakeClock())
    for i, ev in enumerate(trains[:6]):
        (solo_b if i % 2 else solo_a).submit(ADM.SnnRequest(uid=i,
                                                            events=ev))
    solo = {r.uid: r for r in solo_a.run() + solo_b.run()}
    for uid, _, pred, counts, *_ in runs[1][1]:
        assert pred == solo[uid].prediction
        np.testing.assert_array_equal(counts, solo[uid].spike_counts)


def _overlap(side, sims, trains):
    sim_a, sim_b = sims
    dma = side.Dma()
    srv = side.Server(sim_a, batch_slots=2, dma=dma, clock=FakeClock())
    srv.add_model("b", sim_b)
    assert srv.tenants["default"].core_ids & srv.tenants["b"].core_ids
    reqs = []
    for i, model in enumerate(["default", "b", "default"]):
        reqs.append(srv.submit(side.Request(uid=i, events=trains[i],
                                            model=model)))
        srv.step()
    hs = srv.host_summary()
    assert hs["model_swaps"] == 3
    pj_a, _ = dma.table_load(sim_a.register_tables)
    pj_b, _ = dma.table_load(sim_b.register_tables)
    assert hs["swap_pj"] == pytest.approx(2 * pj_a + pj_b)
    assert srv.metrics.get("snn_model_swap_pj_total",
                           {"tenant": "b"}).value == pytest.approx(pj_b)
    return srv, _outcome(reqs)


def test_overlapping_tenants_swap_and_cost_is_register_table_dma():
    ref_a, port_a = _pair(20)
    ref_b, port_b = _pair(21, mapping=ref_a.mapping)
    _assert_runs_equal(_both(_overlap, [(ref_a, port_a), (ref_b, port_b)],
                             _train_pool(seeds=(20, 21))))


def _dma_cost(side, sim, trains):
    srv = side.Server(sim, batch_slots=2, clock=FakeClock())
    r = srv.submit(side.Request(uid=0, events=trains[0]))
    srv.run()
    up_pj, up_cyc = srv.dma.spike_upload(r.timesteps, N_IN)
    out_pj, _ = srv.dma.output_read(SIZES[-1])
    assert r.dma_pj == pytest.approx(up_pj + out_pj)
    assert up_pj > 0 and up_cyc > 0
    _, reports = sim.run_batch(side.arr(
        np.stack([r.events, np.zeros_like(r.events)])))
    assert r.energy_pj == pytest.approx(reports[0].energy_pj, rel=1e-12)
    return srv, _outcome([r])


def test_served_requests_carry_dma_cost_separate_from_chip_energy():
    _assert_runs_equal(_both(_dma_cost, _pair(), _train_pool()))


def test_host_dma_model_and_register_table_bytes_equal_reference():
    kw = dict(word_bits=32, words_per_packet=4, header_words=1,
              setup_cycles=10.0, cycles_per_word=2.0, pj_per_word=1.0)
    ref_sim, port_sim = _pair()
    for dma, ref in ((SOC.HostDmaModel(**kw), REF_SOC.HostDmaModel(**kw)),
                     (SOC.HostDmaModel(), REF_SOC.HostDmaModel())):
        assert dma.transfer(0) == ref.transfer(0) == (0.0, 0.0)
        for n in (1, 5, 64, 65, 1000):
            assert dma.packets(n) == ref.packets(n)
            assert dma.transfer(n) == ref.transfer(n)
        for T, n_in in ((4, 16), (4, 64), (20, 2312), (1, 1)):
            assert dma.spike_upload(T, n_in) == ref.spike_upload(T, n_in)
        assert dma.output_read(10) == ref.output_read(10)
        assert dma.table_load(port_sim.register_tables) == \
            ref.table_load(ref_sim.register_tables)
    pj, cyc = SOC.HostDmaModel(**kw).transfer(5)    # 2 packets, 7 words
    assert (pj, cyc) == (pytest.approx(7.0), pytest.approx(24.0))
    assert [SOC.register_table_bytes(t) for t in port_sim.register_tables] \
        == [REF_SOC.register_table_bytes(t) for t in ref_sim.register_tables]


def test_remap_mapping_cores_errors_as_reference():
    _, port = _pair(strategy="greedy")
    ref, _ = _pair(strategy="greedy")
    for cores, match in (([12], "only 1 physical"), ([0, 1, 2], "not chip")):
        msgs = []
        for mod, sim in ((REF_SOC, ref), (SOC, port)):
            with pytest.raises(ValueError, match=match) as e:
                mod.remap_mapping_cores(sim.mapping, cores)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_enu_program_equal_to_reference():
    assert SOC.ENU_OPCODES == REF_SOC.ENU_OPCODES
    for mask, T in ((0b111, 3), (0xFFFFF, 20)):
        got = SOC.EnuProgram.standard_inference(mask, T)
        want = REF_SOC.EnuProgram.standard_inference(mask, T)
        assert [i.encode() for i in got.instrs] == \
            [i.encode() for i in want.instrs]
        assert got.timeline(1234.5) == want.timeline(1234.5)


# ---------------------------------------------------------------------------
# dispatch resilience: retry, timeout, circuit breaking, degraded (6b)


def _retry(side, sim, trains):
    srv = side.Server(sim, batch_slots=4, clock=FakeClock(),
                      retry=side.Retry(max_retries=2, base_delay_s=0.0),
                      sleep=lambda s: None)
    r = srv.submit(side.Request(uid=0, events=trains[0]))
    done = srv.run()
    assert done[0].status == "served" and not done[0].degraded
    assert _counters(srv)[:3] == (1, 1, 0)
    return srv, _outcome([r])


def test_retry_recovers_from_injected_transient_fault():
    runs = _both(_retry, _pair(transient=(0,)), _train_pool())
    _assert_runs_equal(runs)
    # the retried group equals a healthy server's
    healthy = _both(_retry_free, _pair(), _train_pool())
    _assert_outcomes_equal(runs[1][1], healthy[1][1])


def _retry_free(side, sim, trains):
    srv = side.Server(sim, batch_slots=4, clock=FakeClock())
    r = srv.submit(side.Request(uid=0, events=trains[0]))
    srv.run()
    return srv, _outcome([r])


def _mid_scan(side, sim, trains):
    srv = side.Server(sim, batch_slots=4, clock=FakeClock(),
                      retry=side.Retry(max_retries=0))
    reqs = [srv.submit(side.Request(uid=i, events=trains[i]))
            for i in range(3)]
    with pytest.raises(side.Transient):
        srv.step()
    assert [r.status for r in reqs] == ["queued"] * 3
    assert all(r.t_dequeue is None for r in reqs)
    assert srv.metrics.get("snn_queue_depth").value == 3
    assert srv.metrics.get("snn_requests_served_total").value == 0
    assert _counters(srv)[:2] == (1, 0)
    done = srv.run()
    assert [r.status for r in done] == ["served"] * 3
    return srv, _outcome(reqs)


def test_mid_scan_chip_fault_is_transactional_when_retries_off():
    _assert_runs_equal(_both(_mid_scan, _pair(transient=(0,)),
                             _train_pool()))


def _degraded(side, sims, trains):
    faulty, degraded = sims
    srv = side.Server(None, batch_slots=4, clock=FakeClock(),
                      retry=side.Retry(max_retries=1, base_delay_s=0.0),
                      sleep=lambda s: None)
    srv.add_model("default", faulty, degraded_sim=degraded)
    r = srv.submit(side.Request(uid=0, events=trains[0]))
    done = srv.run()
    assert done[0].status == "served" and done[0].degraded
    assert _counters(srv)[:3] == (2, 1, 1)
    return srv, _outcome([r])


def test_degraded_fallback_after_retry_exhaustion():
    _assert_runs_equal(_both(_degraded, [_pair(transient=(0, 1, 2, 3)),
                                         _pair(30)], _train_pool((0, 30))))


class AdvancingClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 10.0
        return self.t


def _timeout(side, sim, trains):
    srv = side.Server(sim, batch_slots=4, clock=AdvancingClock(),
                      retry=side.Retry(max_retries=0),
                      dispatch_timeout_s=1.0)
    r = srv.submit(side.Request(uid=0, events=trains[0]))
    with pytest.raises(side.Timeout) as e:
        srv.step()
    assert r.status == "queued" and _counters(srv)[0] == 1
    return srv, _outcome([r]), str(e.value)


def test_dispatch_timeout_is_classified_transient():
    runs = _both(_timeout, _pair(), _train_pool())
    _assert_runs_equal(runs)
    assert runs[0][2] == runs[1][2]


def _breaker(side, sims, trains):
    faulty, degraded = sims
    clock = FakeClock()
    srv = side.Server(None, batch_slots=4, clock=clock,
                      retry=side.Retry(max_retries=0, base_delay_s=0.0),
                      breaker_threshold=1, breaker_cooldown_s=5.0,
                      sleep=lambda s: None)
    srv.add_model("default", faulty, degraded_sim=degraded)
    reqs = [srv.submit(side.Request(uid=0, events=trains[0]))]
    done = srv.run()
    assert done[0].degraded and srv.breakers["default"].state == "open"
    dispatches = faulty._dispatch_count
    reqs.append(srv.submit(side.Request(uid=1, events=trains[1])))
    done = srv.run()
    assert done[0].degraded and faulty._dispatch_count == dispatches
    clock.advance(10.0)
    reqs.append(srv.submit(side.Request(uid=2, events=trains[2])))
    done = srv.run()
    assert not done[0].degraded
    assert srv.breakers["default"].state == "closed"
    return srv, _outcome(reqs)


def test_circuit_breaker_opens_serves_degraded_then_recovers():
    _assert_runs_equal(_both(_breaker, [_pair(transient=(0,)), _pair(30)],
                             _train_pool((0, 30))))


def _open_no_degraded(side, sim, trains):
    srv = side.Server(None, batch_slots=4, clock=FakeClock(),
                      retry=side.Retry(max_retries=0, base_delay_s=0.0),
                      breaker_threshold=1, breaker_cooldown_s=5.0)
    srv.add_model("default", sim)
    r = srv.submit(side.Request(uid=0, events=trains[0]))
    with pytest.raises(side.Transient):
        srv.step()
    with pytest.raises(side.CircuitOpen):
        srv.step()
    assert r.status == "queued" and len(srv.queue) == 1
    assert r.t_dequeue is None
    return srv, _outcome([r])


def test_open_circuit_without_degraded_model_keeps_queue():
    _assert_runs_equal(_both(_open_no_degraded, _pair(transient=(0,)),
                             _train_pool()))


def _nonretryable(side, sim, trains):
    srv = side.Server(sim, batch_slots=4, clock=FakeClock(),
                      retry=side.Retry(max_retries=3, base_delay_s=0.0))
    calls = []

    def boom(batch):
        calls.append(1)
        raise RuntimeError("real bug")

    srv.tenants["default"].sim.run_batch = boom
    r = srv.submit(side.Request(uid=0, events=trains[0]))
    with pytest.raises(RuntimeError, match="real bug"):
        srv.step()
    assert len(calls) == 1 and srv._m_retries.value == 0
    return srv, _outcome([r])


def test_nonretryable_error_is_never_retried():
    _assert_runs_equal(_both(_nonretryable, _pair(), _train_pool()))


def test_retryable_is_the_ports_transient_fault():
    assert RES.RETRYABLE == (TransientChipFault, RES.DispatchTimeout)
    assert not issubclass(RefTransient, RES.RETRYABLE)


@pytest.mark.parametrize("kw", [
    {}, dict(seed=7), dict(jitter=0.0), dict(jitter=1.0, seed=3),
    dict(base_delay_s=0.3, max_delay_s=0.5, seed=11)])
def test_retry_delays_equal_reference(kw):
    got, want = RES.RetryPolicy(**kw), REF_RES.RetryPolicy(**kw)
    for attempt in range(8):
        assert got.delay_s(attempt) == want.delay_s(attempt)


@pytest.mark.parametrize("kw,match", [
    (dict(max_retries=-1), "max_retries"), (dict(jitter=1.5), "jitter")])
def test_retry_policy_rejects_as_reference(kw, match):
    for cls in (RES.RetryPolicy, REF_RES.RetryPolicy):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def test_circuit_breaker_state_machine_equal_reference():
    got = RES.CircuitBreaker(failure_threshold=2, cooldown_s=1.0)
    want = REF_RES.CircuitBreaker(failure_threshold=2, cooldown_s=1.0)
    script = [("fail", 0.0), ("allow", 0.1), ("fail", 0.2), ("allow", 0.5),
              ("allow", 1.3), ("fail", 1.4), ("allow", 2.5), ("ok", 2.6),
              ("allow", 2.7)]
    for op, now in script:
        res = []
        for b in (got, want):
            if op == "fail":
                res.append(b.record_failure(now))
            elif op == "ok":
                res.append(b.record_success())
            else:
                res.append(b.allow(now))
        assert res[0] == res[1]
        assert (got.state, got.failures, got.opened_at) == \
            (want.state, want.failures, want.opened_at)
    with pytest.raises(ValueError, match="failure_threshold"):
        RES.CircuitBreaker(failure_threshold=0)


# ---------------------------------------------------------------------------
# the serving path rides the batched engine (test_engine_equiv's server
# tests) and the latency telemetry (test_telemetry's)


def _batches(side, sim, trains):
    srv = side.Server(sim, batch_slots=4, clock=FakeClock())
    for uid, ev in enumerate(trains[:6]):
        srv.submit(side.Request(uid=uid, events=ev))
    done = srv.run()
    assert len(done) == 6
    for r in done:
        assert 0 <= r.prediction < SIZES[-1] and r.energy_pj > 0
        counts, rep = sim.run(side.arr(r.events))
        assert int(np.argmax(np.asarray(counts))) == r.prediction
        np.testing.assert_allclose(r.energy_pj, rep.energy_pj, rtol=1e-12)
    return srv, _outcome(done)


@pytest.mark.parametrize("engine", ["compiled", "fused"])
def test_snn_server_batches_requests(engine):
    _assert_runs_equal(_both(_batches, _pair(engine=engine,
                                             strategy="greedy"),
                             _train_pool()))


def _partial(side, sim, trains):
    srv = side.Server(sim, batch_slots=4, clock=FakeClock())
    for uid, ev in enumerate(trains[:5]):
        srv.submit(side.Request(uid=uid, events=ev))
    done = srv.run()
    assert len(done) == 5 and srv.queue == []
    _, [pad_rep] = sim.run_batch(side.arr(np.zeros((1, STEPS, N_IN),
                                                   np.float32)))
    for r in done:
        counts, rep = sim.run(side.arr(r.events))
        np.testing.assert_allclose(r.energy_pj, rep.energy_pj, rtol=1e-12)
        np.testing.assert_allclose(r.pj_per_sop, rep.pj_per_sop, rtol=1e-12)
        assert r.prediction == int(np.argmax(np.asarray(counts)))
        assert r.energy_pj != pad_rep.energy_pj
    return srv, _outcome(done)


def test_snn_server_partial_group_no_padded_telemetry():
    _assert_runs_equal(_both(_partial, _pair(strategy="greedy"),
                             _train_pool()))


def _quantiles(side, sim, trains):
    clock = FakeClock()
    srv = side.Server(sim, batch_slots=4, clock=clock)
    for uid in range(5):
        srv.submit(side.Request(uid=uid, events=trains[uid]))
        clock.advance(0.0015)
    done = srv.run()
    assert len(done) == 5 and not srv.queue
    for r in done:
        assert r.t_enqueue <= r.t_dequeue <= r.t_complete
    expo = srv.metrics.expose()
    assert 'snn_request_latency_ms{quantile="0.5"}' in expo
    assert 'snn_request_latency_ms{quantile="0.99"}' in expo
    assert "snn_requests_total 5" in expo
    assert "snn_queue_depth 0" in expo
    return srv, _outcome(done), expo


def test_server_timestamps_and_latency_quantiles():
    runs = _both(_quantiles, _pair(), _train_pool())
    _assert_runs_equal(runs)
    # the exposition's non-energy lines are equal text
    keep = ("latency", "queue_wait", "occupancy", "queue_depth",
            "requests_total", "served_total", "shed", "deadline",
            "swaps_total")
    for ref_line, port_line in zip(runs[0][2].splitlines(),
                                   runs[1][2].splitlines()):
        if any(k in ref_line for k in keep):
            assert port_line == ref_line


def test_server_stamps_on_the_real_clock():
    srv = SRV.SnnServer(_pair()[1], batch_slots=4)
    trains = _train_pool()
    for uid in range(5):
        srv.submit(ADM.SnnRequest(uid=uid, events=trains[uid]))
    for r in srv.run():
        assert r.t_enqueue <= r.t_dequeue <= r.t_complete


def test_group_batch_crosses_once_each_way(monkeypatch):
    """The padded slot batch goes to the simulator's device as one tensor
    and the counts come back once: `run_batch` sees one (slots, T, n_in)
    f32 tensor, its counts are read on the host by one `.cpu()`."""
    sim = _pair()[1]
    seen = []
    real = sim.run_batch

    def spy(batch):
        seen.append(batch)
        counts, reports = real(batch)
        return _CountingTensor(counts), reports

    sim.run_batch = spy
    srv = SRV.SnnServer(sim, batch_slots=4, clock=FakeClock())
    trains = _train_pool()
    for uid in range(3):
        srv.submit(ADM.SnnRequest(uid=uid, events=trains[uid]))
    srv.run()
    assert len(seen) == 1 and isinstance(seen[0], torch.Tensor)
    assert seen[0].shape == (4, STEPS, N_IN)
    assert seen[0].dtype == torch.float32
    assert seen[0].device == sim.device
    assert _CountingTensor.cpu_calls == 1
    assert not seen[0][3].any()              # the padded slot is zero


class _CountingTensor:
    cpu_calls = 0

    def __init__(self, t):
        self.t = t

    def cpu(self):
        type(self).cpu_calls += 1
        return self.t.cpu()


# ---------------------------------------------------------------------------
# admission policy: the reference's property sweeps (hypothesis), and the
# same invariants on seeded random queues held to the reference's
# functions


def _mk_queue(mod, raw):
    queue = []
    for uid, (model, T, deadline, t_enq) in enumerate(raw):
        r = mod.SnnRequest(uid=uid, events=np.zeros((T, 4), np.float32),
                           model=model)
        r.t_enqueue = t_enq
        r.deadline = deadline
        queue.append(r)
    return queue


def _random_raw(rng, n):
    return [(str(rng.choice(["a", "b"])), int(rng.integers(1, 4)),
             None if rng.random() < 0.3 else float(rng.uniform(0, 10)),
             float(rng.uniform(0, 10))) for _ in range(n)]


def _key(r):
    return (r.deadline if r.deadline is not None else math.inf,
            r.t_enqueue if r.t_enqueue is not None else math.inf)


def _check_group(queue, group, slots):
    assert len(group) <= slots
    assert len({(r.model, r.timesteps) for r in group}) <= 1
    keys = [_key(r) for r in group]
    assert keys == sorted(keys)
    if group:
        for r in queue:
            assert keys[0] <= _key(r) or (r.model, r.timesteps) == (
                group[0].model, group[0].timesteps)


@pytest.mark.parametrize("seed", range(4))
def test_admission_selection_equal_to_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        raw = _random_raw(rng, int(rng.integers(0, 13)))
        now = float(rng.uniform(0, 12))
        slots = int(rng.integers(1, 5))
        got_q, want_q = _mk_queue(ADM, raw), _mk_queue(REF_ADM, raw)
        dead = ADM.expired(got_q, now)
        assert [r.uid for r in dead] == \
            [r.uid for r in REF_ADM.expired(want_q, now)]
        for r in dead:
            assert r.deadline is not None and now >= r.deadline
        gone = {r.uid for r in dead}
        live = [r for r in got_q if r.uid not in gone]
        group = ADM.form_group(live, slots, now)
        want = REF_ADM.form_group([r for r in want_q if r.uid not in gone],
                                  slots, now)
        assert [r.uid for r in group] == [r.uid for r in want]
        assert not ({r.uid for r in group} & gone)
        _check_group(got_q, ADM.form_group(got_q, slots, now), slots)


@pytest.mark.parametrize("seed", range(3))
def test_validate_events_equal_to_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        shape = (int(rng.integers(0, 4)), int(rng.choice([3, 4, 5])))
        ev = rng.choice([0.0, 1.0, 0.5, np.nan, -1.0], size=shape,
                        p=[0.5, 0.4, 0.04, 0.03, 0.03]).astype(np.float32)
        before = ev.copy()
        outs = []
        for mod in (ADM, REF_ADM):
            try:
                outs.append(mod.validate_events(ev, 4, uid=0))
            except ValueError as e:
                outs.append(str(e))
        if isinstance(outs[1], str):
            assert outs[0] == outs[1]
        else:
            assert outs[0].dtype == np.float32 and outs[0].shape[1] == 4
            np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_array_equal(ev, before)


def test_group_order_stable_under_deadline_ties():
    for n in range(2, 9):
        queue = []
        for uid in range(n):
            r = ADM.SnnRequest(uid=uid, events=np.zeros((2, 4), np.float32))
            r.t_enqueue = float(uid)
            r.deadline = 5.0
            queue.append(r)
        g1 = ADM.form_group(queue, n, now=0.0)
        g2 = ADM.form_group(list(reversed(queue)), n, now=0.0)
        assert [r.uid for r in g1] == list(range(n))
        assert [r.uid for r in g1] == [r.uid for r in g2]


if HAVE_HYPOTHESIS:
    _events = st.lists(
        st.lists(st.floats(allow_nan=True, allow_infinity=False, width=32),
                 min_size=1, max_size=6), min_size=0, max_size=5).map(
            lambda rows: np.asarray(rows, np.float32)
            if rows and len({len(r) for r in rows}) == 1
            else np.zeros((0, 4), np.float32))
    _requests = st.lists(st.tuples(
        st.sampled_from(["a", "b"]), st.integers(min_value=1, max_value=3),
        st.one_of(st.none(), st.floats(min_value=0.0, max_value=10.0)),
        st.floats(min_value=0.0, max_value=10.0)), min_size=0, max_size=12)
else:                                    # inert placeholders; tests skip
    _events = _requests = None


@settings(max_examples=60, deadline=None)
@given(events=_events)
def test_validate_events_returns_binary_or_raises(events):
    before = events.copy()
    try:
        out = ADM.validate_events(events, 4, uid=0)
    except ValueError:
        pass
    else:
        assert out.dtype == np.float32 and out.ndim == 2
        assert out.shape[1] == 4 and out.shape[0] >= 1
        assert np.all((out == 0.0) | (out == 1.0))
    np.testing.assert_array_equal(events, before)


@settings(max_examples=60, deadline=None)
@given(raw=_requests, now=st.floats(min_value=0.0, max_value=12.0),
       slots=st.integers(min_value=1, max_value=4))
def test_formed_group_is_one_bucket_in_deadline_order(raw, now, slots):
    queue = _mk_queue(ADM, raw)
    _check_group(queue, ADM.form_group(queue, slots, now), slots)
    dead = ADM.expired(queue, now)
    live = [r for r in queue if r not in dead]
    assert not ({id(r) for r in ADM.form_group(live, slots, now)}
                & {id(r) for r in dead})
