"""Dispatch resilience for the serving tier: retry, timeout, breaker.

A copy of `repro.serve.resilience`; `RETRYABLE` holds the port's own
`repro_torch.faults.model.TransientChipFault`, the fault the port's
`ChipSimulator._consume_transient_fault` raises.

Three small, composable mechanisms `SnnServer` threads around its
transactional dispatch (see snn_server.py):

* **bounded retry with jittered exponential backoff** (`RetryPolicy`) —
  retries ONLY the retryable failures: `faults.TransientChipFault` (the
  scan ran, the readback was lost) and `DispatchTimeout`.  Anything else
  — a real bug, a shape error, a mocked engine raise — stays
  fatal and propagates transactionally.  Backoff
  jitter derives from `SeedSequence` (no global RNG), so a retry
  schedule is a value: same policy, same delays.
* **per-dispatch timeout** (`DispatchTimeout`) — the engines run
  synchronously, so the timeout is detected post-hoc against the
  server's injectable clock and classified as transient (a wedged
  dispatch on real hardware is indistinguishable from a lost one).
* **per-tenant circuit breaking** (`CircuitBreaker`) — `closed` until
  `failure_threshold` consecutive dispatch failures, then `open`
  (primary never tried) for `cooldown_s`, then `half_open`: one trial
  dispatch, success re-closes, failure re-opens.  While not closed the
  server completes requests through the tenant's *degraded* simulator
  (a repaired chip — `compiler.repair` — with `degraded=True` stamped
  on every result) instead of shedding them; with no degraded model
  registered the breaker raises `CircuitOpenError` and the group stays
  queued.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.faults.model import TransientChipFault

__all__ = ["CircuitBreaker", "CircuitOpenError", "DispatchTimeout",
           "RETRYABLE", "RetryPolicy"]


class DispatchTimeout(RuntimeError):
    """A dispatch exceeded the server's per-dispatch timeout budget."""


class CircuitOpenError(RuntimeError):
    """A tenant's circuit is open and it has no degraded model to serve
    through; its requests stay queued until the cooldown elapses."""


# the retryable failures; everything else propagates transactionally
RETRYABLE = (TransientChipFault, DispatchTimeout)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with seeded, jittered exponential backoff.

    Retry `attempt` (0-based) sleeps ``base_delay_s * 2**attempt``
    capped at `max_delay_s`, scaled by ``1 - jitter * u`` with `u` drawn
    from `SeedSequence([seed, attempt])` — deterministic per policy, and
    decorrelated across servers with different seeds.
    """

    max_retries: int = 2
    base_delay_s: float = 0.02
    max_delay_s: float = 1.0
    jitter: float = 0.5            # fraction of the delay randomized away
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delay_s(self, attempt: int) -> float:
        d = min(float(self.base_delay_s) * (2.0 ** int(attempt)),
                float(self.max_delay_s))
        if self.jitter > 0.0:
            rng = np.random.Generator(np.random.PCG64(
                np.random.SeedSequence([int(self.seed), int(attempt)])))
            d *= 1.0 - float(self.jitter) * float(rng.random())
        return d


class CircuitBreaker:
    """closed -> open -> half_open consecutive-failure circuit breaker.

    Pure state machine against an injected `now` (the server's clock):
    `allow(now)` answers whether the primary may be tried, and
    `record_success` / `record_failure(now)` advance the state.
    """

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 5.0):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, "
                             f"got {failure_threshold}")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.failures = 0              # consecutive primary failures
        self.state = "closed"
        self.opened_at: float | None = None

    def allow(self, now: float) -> bool:
        """May the primary be dispatched right now?  Transitions
        open -> half_open when the cooldown has elapsed."""
        if self.state == "open":
            if now - self.opened_at >= self.cooldown_s:
                self.state = "half_open"
                return True
            return False
        return True                    # closed or half_open (one trial)

    def record_success(self) -> None:
        self.failures = 0
        self.state = "closed"
        self.opened_at = None

    def record_failure(self, now: float) -> None:
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.failure_threshold:
            self.state = "open"
            self.opened_at = now
