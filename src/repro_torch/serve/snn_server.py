"""Continuous-batching SNN event-stream serving on the port's batched
chip engines, with deadlines, bounded admission, multi-model tenancy, and
a DMA-modeled host<->chip interface.

Port of `repro.serve.snn_server`, behaviour for behaviour:

* **continuous in-flight batching** — `step()` forms ONE slot group as
  soon as slots free up (bucket by (model, T), oldest-deadline-first
  within the bucket) and serves it; a request arriving while a group is
  in flight joins the *next* group.  `run()` is `step()` until idle.
* **admission control** — the queue is depth-bounded; at capacity
  `submit` completes the request with an explicit `shed` status (never a
  silent drop).  Requests may carry a `deadline_ms`; expired requests
  are completed `deadline_exceeded` at dispatch time, before they waste
  an engine launch.
* **multi-model tenancy** — `add_model()` registers more simulators.
  Tenants whose mappings occupy disjoint core sets (see
  `core.soc.remap_mapping_cores`) are co-resident on the one simulated
  chip; tenants that contend for cores evict each other, and every
  residency change is priced as a reconfiguration DMA of the incoming
  model's register tables (`core.soc.HostDmaModel.table_load`).
* **DMA-modeled dispatch** — every served request is charged the host
  interface: bitpacked spike-train upload + OBUF readback
  (`SnnRequest.dma_pj`, kept separate from the on-chip `energy_pj`).

The crossing to the card: a group's slot batch is assembled in numpy,
zero-padded to `batch_slots`, and goes to the tenant simulator's device
in one copy; its output counts come back to the host in one copy per
group, beside the engine's own counter readback.  Nothing crosses per
request.

Failure is transactional per group: if the engine raises, the group's
`t_dequeue` stamps are cleared, no metrics are recorded for it, the
requests stay queued, and the exception propagates.

Resilience (see serve/resilience.py): transient dispatch failures —
`faults.TransientChipFault` and `DispatchTimeout` — are retried with
jittered exponential backoff before the transactional unwind; repeated
failures open a per-tenant circuit breaker; and a tenant registered with
a `degraded_sim` (a `compiler.repair`-ed chip) completes requests
through it with `degraded=True` instead of shedding when the primary is
unavailable.  Fatal errors (anything non-transient) propagate.  Surfaced
as `snn_faults_injected` / `snn_retries` / `snn_degraded_total` metrics.

Metrics: the server maintains a `telemetry.MetricsRegistry` with global
series (latency/queue-wait/occupancy histograms, queue-depth gauge,
request/shed/deadline counters) plus per-tenant labelled series
(`snn_request_latency_ms{tenant="..."}` etc.), the port's
`telemetry.metrics` exposition.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.soc import ChipSimulator, HostDmaModel
from repro_torch.serve import admission as ADM
from repro_torch.serve.admission import (DEADLINE_EXCEEDED, QUEUED, SERVED,
                                         SHED, SnnRequest)
from repro_torch.serve.resilience import (RETRYABLE, CircuitBreaker,
                                          CircuitOpenError, DispatchTimeout,
                                          RetryPolicy)
from repro_torch.telemetry.metrics import MetricsRegistry

__all__ = ["SnnRequest", "SnnServer", "Tenant"]


class Tenant:
    """One registered model: a compiled simulator plus residency state."""

    def __init__(self, name: str, sim: ChipSimulator,
                 degraded_sim: ChipSimulator | None = None):
        if sim.engine not in ("compiled", "fused"):
            raise ValueError("SnnServer requires an array-engine simulator "
                             "(engine='compiled' or 'fused')")
        self.name = name
        self.sim = sim
        self.n_in = int(sim.weights[0].shape[0])
        self.n_out = int(sim.weights[-1].shape[1])
        self.core_ids = frozenset(sim.mapping.active_core_ids())
        self.resident = False
        if degraded_sim is not None:
            if degraded_sim.engine not in ("compiled", "fused"):
                raise ValueError(
                    "degraded_sim must be an array-engine simulator")
            din = int(degraded_sim.weights[0].shape[0])
            dout = int(degraded_sim.weights[-1].shape[1])
            if (din, dout) != (self.n_in, self.n_out):
                raise ValueError(
                    f"degraded_sim io ({din}, {dout}) does not match the "
                    f"primary's ({self.n_in}, {self.n_out})")
        self.degraded_sim = degraded_sim


class SnnServer:
    """Deadline-aware continuous batching over per-(model, T) executables."""

    def __init__(self, sim: ChipSimulator, batch_slots: int = 8,
                 registry: MetricsRegistry | None = None,
                 max_queue_depth: int | None = 256,
                 dma: HostDmaModel | None = None,
                 clock=time.monotonic,
                 retry: RetryPolicy | None = None,
                 dispatch_timeout_s: float | None = None,
                 breaker_threshold: int = 0,
                 breaker_cooldown_s: float = 5.0,
                 sleep=time.sleep):
        self.slots = batch_slots
        self.max_queue_depth = max_queue_depth
        self.dma = dma if dma is not None else HostDmaModel()
        self.clock = clock
        # resilience knobs: retries cover ONLY transient faults/timeouts;
        # breaker_threshold=0 disables circuit breaking entirely
        self.retry = retry if retry is not None else RetryPolicy()
        self.dispatch_timeout_s = dispatch_timeout_s
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.sleep = sleep
        self.breakers: dict[str, CircuitBreaker] = {}
        self.queue: list[SnnRequest] = []
        self.tenants: dict[str, Tenant] = {}
        self.metrics = registry if registry is not None else MetricsRegistry()
        m = self.metrics
        self._m_requests = m.counter(
            "snn_requests_total", "requests accepted by submit()")
        self._m_served = m.counter(
            "snn_requests_served_total", "requests completed by dispatch")
        self._m_shed = m.counter(
            "snn_requests_shed_total",
            "requests rejected at admission (queue at capacity)")
        self._m_deadline = m.counter(
            "snn_requests_deadline_exceeded_total",
            "requests expired before launch")
        self._m_queue = m.gauge(
            "snn_queue_depth", "requests currently queued")
        self._m_latency = m.histogram(
            "snn_request_latency_ms", "submit -> complete wall time")
        self._m_wait = m.histogram(
            "snn_request_queue_wait_ms", "submit -> group dispatch wait")
        self._m_occupancy = m.histogram(
            "snn_batch_occupancy", "real requests per served slot group")
        self._m_pj = m.histogram(
            "snn_request_energy_pj", "chip-model energy per request")
        self._m_pj_sop = m.histogram(
            "snn_request_pj_per_sop", "chip-model pJ/SOP per request")
        self._m_dma_pj = m.counter(
            "snn_dma_pj_total",
            "host-interface DMA energy (spike upload + output read)")
        self._m_swaps = m.counter(
            "snn_model_swaps_total",
            "model residency loads (reconfiguration DMAs)")
        self._m_swap_pj = m.counter(
            "snn_model_swap_pj_total",
            "reconfiguration DMA energy (register-table loads)")
        self._m_swap_cycles = m.counter(
            "snn_model_swap_cycles_total",
            "reconfiguration DMA cycles (register-table loads)")
        self._m_faults = m.counter(
            "snn_faults_injected",
            "transient dispatch faults observed (injected or timeout)")
        self._m_retries = m.counter(
            "snn_retries", "dispatch retries after transient faults")
        self._m_degraded = m.counter(
            "snn_degraded_total",
            "requests completed through a degraded (repaired-chip) model")
        self._per_tenant: dict[str, dict] = {}
        if sim is not None:
            self.add_model("default", sim)

    # -- tenancy ------------------------------------------------------------

    def add_model(self, name: str, sim: ChipSimulator,
                  degraded_sim: ChipSimulator | None = None) -> Tenant:
        """Register a compiled network under `name`.  Tenants with
        disjoint core sets co-reside; overlapping tenants swap.
        `degraded_sim` (typically a `compiler.repair`-ed chip) serves the
        tenant's requests with `degraded=True` whenever the primary is
        unavailable (open circuit, exhausted transient retries)."""
        if name in self.tenants:
            raise ValueError(f"model {name!r} already registered")
        t = Tenant(name, sim, degraded_sim=degraded_sim)
        self.tenants[name] = t
        if self.breaker_threshold > 0:
            self.breakers[name] = CircuitBreaker(
                failure_threshold=self.breaker_threshold,
                cooldown_s=self.breaker_cooldown_s)
        m, lbl = self.metrics, {"tenant": name}
        self._per_tenant[name] = {
            "requests": m.counter("snn_requests_total",
                                  "requests accepted by submit()", lbl),
            "served": m.counter("snn_requests_served_total",
                                "requests completed by dispatch", lbl),
            "shed": m.counter("snn_requests_shed_total",
                              "requests rejected at admission", lbl),
            "deadline": m.counter("snn_requests_deadline_exceeded_total",
                                  "requests expired before launch", lbl),
            "latency": m.histogram("snn_request_latency_ms",
                                   "submit -> complete wall time",
                                   labels=lbl),
            "pj_sop": m.histogram("snn_request_pj_per_sop",
                                  "chip-model pJ/SOP per request",
                                  labels=lbl),
            "swap_pj": m.counter("snn_model_swap_pj_total",
                                 "reconfiguration DMA energy", lbl),
        }
        return t

    @property
    def sim(self) -> ChipSimulator:
        """The default tenant's simulator (single-model compatibility)."""
        return self.tenants["default"].sim

    def _ensure_resident(self, tenant: Tenant) -> None:
        """Make `tenant` resident, evicting core-set conflicts; every
        load is priced as a reconfiguration DMA of its register tables."""
        if tenant.resident:
            return
        for other in self.tenants.values():
            if other.resident and other.core_ids & tenant.core_ids:
                other.resident = False
        pj, cycles = self.dma.table_load(tenant.sim.register_tables)
        tenant.resident = True
        self._m_swaps.inc()
        self._m_swap_pj.inc(pj)
        self._m_swap_cycles.inc(cycles)
        self._per_tenant[tenant.name]["swap_pj"].inc(pj)

    # -- admission ----------------------------------------------------------

    def submit(self, req: SnnRequest) -> SnnRequest:
        """Admit (or shed) a request; returns it with its status set."""
        tenant = self.tenants.get(req.model)
        if tenant is None:
            raise ValueError(f"request {req.uid}: unknown model "
                             f"{req.model!r} (registered: "
                             f"{sorted(self.tenants)})")
        req.events = ADM.validate_events(req.events, tenant.n_in, req.uid)
        now = self.clock()
        req.t_enqueue = now
        if req.deadline_ms is not None:
            req.deadline = now + float(req.deadline_ms) * 1e-3
        self._m_requests.inc()
        self._per_tenant[req.model]["requests"].inc()
        if (self.max_queue_depth is not None
                and len(self.queue) >= self.max_queue_depth):
            # bounded-depth backpressure: explicit shed result, never a
            # silent drop — the caller gets the request back, completed
            req.status = SHED
            req.t_complete = now
            self._m_shed.inc()
            self._per_tenant[req.model]["shed"].inc()
            return req
        req.status = QUEUED
        self.queue.append(req)
        self._m_queue.set(len(self.queue))
        return req

    # -- dispatch -----------------------------------------------------------

    def _expire(self, now: float) -> list[SnnRequest]:
        """Complete overdue requests with `deadline_exceeded` — before
        group formation, so they never cost an executable launch."""
        dead = ADM.expired(self.queue, now)
        if not dead:
            return []
        gone = {id(r) for r in dead}
        self.queue = [r for r in self.queue if id(r) not in gone]
        self._m_queue.set(len(self.queue))
        for r in dead:
            r.status = DEADLINE_EXCEEDED
            r.t_complete = now
            self._m_deadline.inc()
            self._per_tenant[r.model]["deadline"].inc()
        return dead

    def _serve_group(self, tenant: Tenant,
                     group: list[SnnRequest]) -> None:
        """Run one slot group through the tenant's engine.  Transactional:
        metrics and result stamps land only after the engine returns; on
        failure the dequeue stamps are cleared and the exception
        propagates (the caller has not removed the group from the queue
        yet, so nothing is lost and the depth gauge stays exact)."""
        t_dequeue = self.clock()
        for r in group:
            r.t_dequeue = t_dequeue
        try:
            T = group[0].timesteps
            batch = np.zeros((self.slots, T, tenant.n_in), np.float32)
            for i, r in enumerate(group):
                batch[i] = r.events
            # one host -> device copy of the padded slot batch, one
            # device -> host copy of its counts
            counts, reports, degraded = self._dispatch(
                tenant, torch.from_numpy(batch).to(tenant.sim.device))
            counts = counts.cpu().numpy()
        except Exception:
            for r in group:
                r.t_dequeue = None
            raise
        t_complete = self.clock()
        up_pj, _ = self.dma.spike_upload(T, tenant.n_in)
        out_pj, _ = self.dma.output_read(tenant.n_out)
        self._m_occupancy.observe(len(group))
        per = self._per_tenant[tenant.name]
        for i, r in enumerate(group):
            r.spike_counts = counts[i]
            r.prediction = int(counts[i].argmax())
            r.energy_pj = reports[i].energy_pj
            r.pj_per_sop = reports[i].pj_per_sop
            r.dma_pj = up_pj + out_pj
            r.t_complete = t_complete
            r.status = SERVED
            r.degraded = degraded
            if degraded:
                self._m_degraded.inc()
            self._m_dma_pj.inc(r.dma_pj)
            self._m_served.inc()
            per["served"].inc()
            self._m_latency.observe((t_complete - r.t_enqueue) * 1e3)
            per["latency"].observe((t_complete - r.t_enqueue) * 1e3)
            self._m_wait.observe((r.t_dequeue - r.t_enqueue) * 1e3)
            self._m_pj.observe(r.energy_pj)
            self._m_pj_sop.observe(r.pj_per_sop)
            per["pj_sop"].observe(r.pj_per_sop)

    def _dispatch(self, tenant: Tenant, batch):
        """Resilient dispatch for one slot group.

        Breaker gate -> primary with bounded retry over RETRYABLE
        failures (`TransientChipFault`, `DispatchTimeout`) -> degraded
        fallback.  Returns `(counts, reports, degraded_flag)`.  Anything
        non-retryable — a real engine bug — propagates immediately to
        `_serve_group`'s transactional unwind.
        """
        breaker = self.breakers.get(tenant.name)
        if breaker is not None and not breaker.allow(self.clock()):
            # circuit open: primary never tried, cooldown not yet elapsed
            return self._degraded_dispatch(tenant, batch, None)
        last: Exception | None = None
        for attempt in range(self.retry.max_retries + 1):
            if attempt > 0:
                self._m_retries.inc()
                self.sleep(self.retry.delay_s(attempt - 1))
            try:
                counts, reports = self._primary_dispatch(tenant, batch)
            except RETRYABLE as e:
                self._m_faults.inc()
                last = e
                continue
            if breaker is not None:
                breaker.record_success()
            return counts, reports, False
        # transient retries exhausted: one dispatch-level failure
        if breaker is not None:
            breaker.record_failure(self.clock())
        return self._degraded_dispatch(tenant, batch, last)

    def _primary_dispatch(self, tenant: Tenant, batch):
        """One primary engine launch, classified against the per-dispatch
        timeout budget.  The engines run synchronously, so the timeout is
        detected post-hoc — a wedged dispatch on real hardware is
        indistinguishable from a lost one, so it is transient/retryable."""
        t0 = self.clock()
        counts, reports = tenant.sim.run_batch(batch)
        elapsed = self.clock() - t0
        if (self.dispatch_timeout_s is not None
                and elapsed > self.dispatch_timeout_s):
            raise DispatchTimeout(
                f"tenant {tenant.name!r}: dispatch took {elapsed:.3f}s, "
                f"over the {self.dispatch_timeout_s}s budget")
        return counts, reports

    def _degraded_dispatch(self, tenant: Tenant, batch, cause):
        """Complete the group through the tenant's degraded simulator
        (`degraded=True` on every result) instead of shedding.  With no
        degraded model the failure propagates transactionally: `cause`
        when the primary's retries were exhausted, `CircuitOpenError`
        when the circuit was open — either way the group stays queued."""
        if tenant.degraded_sim is None:
            if cause is not None:
                raise cause
            raise CircuitOpenError(
                f"tenant {tenant.name!r}: circuit open and no degraded "
                f"model registered; requests stay queued until the "
                f"cooldown elapses")
        counts, reports = tenant.degraded_sim.run_batch(batch)
        return counts, reports, True

    def step(self) -> list[SnnRequest]:
        """One dispatch round: expire overdue requests, then form and
        serve at most ONE slot group.  Returns every request completed
        this round (served + expired).  New submissions between steps
        join the next group — this is the continuous-batching loop."""
        now = self.clock()
        done = self._expire(now)
        group = ADM.form_group(self.queue, self.slots, now)
        if not group:
            return done
        tenant = self.tenants[group[0].model]
        self._ensure_resident(tenant)
        self._serve_group(tenant, group)        # raises transactionally
        served = {id(r) for r in group}
        self.queue = [r for r in self.queue if id(r) not in served]
        self._m_queue.set(len(self.queue))
        return done + group

    def run(self) -> list[SnnRequest]:
        """Drain: `step()` until the queue is idle.  Kept for the batch
        API; sustained-load callers drive `step()` themselves and keep
        submitting between rounds."""
        done: list[SnnRequest] = []
        while self.queue:
            done.extend(self.step())
        return done

    # -- host-interface accounting ------------------------------------------

    def host_summary(self) -> dict:
        """DMA/reconfiguration totals the dispatch loop accumulated."""
        return {
            "dma_pj": self._m_dma_pj.value,
            "model_swaps": self._m_swaps.value,
            "swap_pj": self._m_swap_pj.value,
            "swap_cycles": self._m_swap_cycles.value,
        }
