"""Admission control for the SNN serving tier: request lifecycle,
validation, deadline bookkeeping, and deadline-aware group formation.

A copy of `repro.serve.admission` (numpy only), so the port imports
nothing of the JAX package.

The serving tier's unit of work is an `SnnRequest` — one (T, n_in)
binary event train bound for one registered model.  This module holds
the *policy* half of the tier as pure functions over a plain request
list (the server owns the list; nothing here mutates it), so the
dispatch loop in `snn_server.py` stays a thin transactional shell:

* `validate_events` — the submit-time contract: 2-D, the model's input
  width, `T >= 1` (a zero-length train would build a `(slots, 0, n_in)`
  batch and crash inside the engine scan), and binary {0, 1} values
  (non-binary floats would silently corrupt the spike-count-driven
  energy accounting).
* `expired` — requests whose absolute deadline has passed; the server
  completes them with `deadline_exceeded` *before* group formation so
  they never waste an executable launch.
* `form_group` — the next slot group: requests bucket by (model, T)
  because each (mapping, T, slots) triple is its own compiled
  executable, the bucket whose head is oldest-deadline-first wins, and
  within the bucket requests are taken oldest-deadline-first
  (no-deadline requests order by enqueue time, i.e. FIFO).

Request lifecycle::

    created -> queued -> served
                      -> deadline_exceeded   (expired before launch)
             -> shed                          (bounded queue full)

A request that reaches any terminal status carries a `t_complete`
stamp; `shed` and `deadline_exceeded` are explicit results handed back
to the caller, never silent drops.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# terminal + transient request statuses
CREATED = "created"
QUEUED = "queued"
SERVED = "served"
SHED = "shed"
DEADLINE_EXCEEDED = "deadline_exceeded"


@dataclasses.dataclass
class SnnRequest:
    """One event-train inference request.

    `deadline_ms` is relative to admission; `submit` converts it to the
    absolute monotonic `deadline`.  `dma_pj` is the host-interface cost
    (spike upload + output readback) attributed to this request by the
    DMA model — kept separate from `energy_pj`, which remains the
    on-chip accounting of the engines.
    """

    uid: int
    events: np.ndarray                  # (T, n_in) binary spike train
    model: str = "default"              # registered tenant name
    deadline_ms: float | None = None    # latency budget from enqueue
    status: str = CREATED
    prediction: int | None = None
    spike_counts: np.ndarray | None = None
    energy_pj: float = 0.0
    pj_per_sop: float = 0.0
    dma_pj: float = 0.0
    # True when the result came from the tenant's degraded (repaired-
    # chip) model because the primary's circuit was open or its retries
    # were exhausted — completed, not shed, but accuracy may differ
    degraded: bool = False
    # monotonic lifecycle timestamps (time.monotonic seconds):
    # t_enqueue <= t_dequeue <= t_complete once served
    t_enqueue: float | None = None
    t_dequeue: float | None = None
    t_complete: float | None = None
    deadline: float | None = None       # absolute, set at submit

    @property
    def timesteps(self) -> int:
        return int(self.events.shape[0])


def validate_events(events, n_in: int, uid) -> np.ndarray:
    """Submit-time event-train contract; returns the f32 binary array."""
    events = np.asarray(events)
    if events.ndim != 2 or int(events.shape[1]) != n_in:
        raise ValueError(
            f"request {uid}: events must be (T, {n_in}), "
            f"got {tuple(events.shape)}")
    if int(events.shape[0]) < 1:
        raise ValueError(
            f"request {uid}: events must span at least one timestep "
            f"(T >= 1), got T={int(events.shape[0])} — a zero-length "
            f"train has nothing to infer from")
    ev = events.astype(np.float32)
    if not np.all((ev == 0.0) | (ev == 1.0)):
        bad = ev[(ev != 0.0) & (ev != 1.0)]
        raise ValueError(
            f"request {uid}: events must be binary {{0, 1}} spike "
            f"indicators (got values like "
            f"{np.unique(bad)[:4].tolist()}); analog values would "
            f"corrupt the spike-count energy accounting")
    return ev


def _key(r: SnnRequest) -> tuple[float, float]:
    """Oldest-deadline-first; no-deadline requests fall back to FIFO."""
    return (r.deadline if r.deadline is not None else math.inf,
            r.t_enqueue if r.t_enqueue is not None else math.inf)


def expired(queue: list[SnnRequest], now: float) -> list[SnnRequest]:
    """Requests whose absolute deadline has passed (selection only)."""
    return [r for r in queue
            if r.deadline is not None and now >= r.deadline]


def form_group(queue: list[SnnRequest], slots: int,
               now: float) -> list[SnnRequest]:
    """Select the next slot group (non-destructively).

    Buckets by (model, T) — each is its own compiled executable — and
    picks the bucket whose head request is most urgent, then fills up to
    `slots` requests from that bucket in deadline order.  Expired
    requests must have been removed first (see `expired`).
    """
    buckets: dict[tuple[str, int], list[SnnRequest]] = {}
    for r in queue:
        buckets.setdefault((r.model, r.timesteps), []).append(r)
    if not buckets:
        return []
    for b in buckets.values():
        b.sort(key=_key)
    chosen = min(buckets.values(), key=lambda b: _key(b[0]))
    return chosen[:slots]
