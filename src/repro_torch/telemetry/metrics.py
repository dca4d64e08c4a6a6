"""Lightweight serving metrics: counters, gauges, histograms with
p50/p95/p99, optional label sets, and a registry with a Prometheus-style
text exposition.

Port of `repro.telemetry.metrics` (pure Python, as in the reference).

No external client library (the container pins its dependency set), so
this is the minimal self-contained subset the serve tier needs:

    reg = MetricsRegistry()
    lat = reg.histogram("snn_request_latency_ms", "end-to-end latency")
    lat.observe(1.7)
    ten = reg.histogram("snn_request_latency_ms", "end-to-end latency",
                        labels={"tenant": "mnist"})   # per-tenant series
    print(reg.expose())          # text format, scrape-friendly

Labelled metrics are separate time series under one metric *family*:
``# HELP``/``# TYPE`` are emitted once per family, followed by every
series (``name{tenant="mnist"} 3``).  The family pins the metric type —
registering ``name`` as a counter and ``name{...}`` as a gauge raises.

Histograms keep a bounded sample window (`max_samples`, default 8192,
oldest evicted first) and compute nearest-rank percentiles over it.
**Quantiles are window-scoped** — they describe the most recent
`max_samples` observations, which is what a latency SLO wants under
sustained load — while **`_sum`/`_count` are lifetime** totals over every
`observe()` since creation, Prometheus summary convention.  Asking for
the same histogram with a different `max_samples` raises (a silent
window change would silently change what the quantiles mean).
Everything is process-local and synchronous, matching the
single-threaded `SnnServer` dispatch loop.
"""
from __future__ import annotations

import math
from collections import deque


def _fmt(v: float) -> str:
    """Prometheus text-format float: ``inf``/``nan`` repr is invalid in
    the exposition format, which requires ``+Inf``/``-Inf``/``NaN``."""
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return f"{v:.6g}"


def _escape_help(s: str) -> str:
    """Escape a ``# HELP`` line per the text format: backslash and
    newline must be written as ``\\\\`` and ``\\n``."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _series_name(name: str, labels: dict | None,
                 extra: dict | None = None) -> str:
    """Render ``name{k="v",...}`` with sorted label keys (stable series
    identity); `extra` labels (e.g. quantile) are appended last."""
    items = sorted((labels or {}).items())
    if extra:
        items += list(extra.items())
    if not items:
        return name
    inner = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                     for k, v in items)
    return f"{name}{{{inner}}}"


class _Metric:
    """Shared identity: a family name plus an optional label set."""

    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None

    @property
    def series(self) -> str:
        return _series_name(self.name, self.labels)

    def _head(self, kind: str) -> list[str]:
        return [f"# HELP {self.name} {_escape_help(self.help)}",
                f"# TYPE {self.name} {kind}"]


class Counter(_Metric):
    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None):
        super().__init__(name, help, labels)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (inc {n})")
        self.value += n

    def sample_lines(self) -> list[str]:
        return [f"{self.series} {_fmt(self.value)}"]

    def expose(self) -> list[str]:
        return self._head("counter") + self.sample_lines()


class Gauge(_Metric):
    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None):
        super().__init__(name, help, labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def sample_lines(self) -> list[str]:
        return [f"{self.series} {_fmt(self.value)}"]

    def expose(self) -> list[str]:
        return self._head("gauge") + self.sample_lines()


class Histogram(_Metric):
    """Sample-window histogram exposed as a summary (quantiles + sum/count).

    Quantiles are computed over the retained window (most recent
    `max_samples` observations); `_sum`/`_count` accumulate over the
    metric's lifetime.
    """

    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, name: str, help: str = "", max_samples: int = 8192,
                 labels: dict | None = None):
        super().__init__(name, help, labels)
        self.samples: deque[float] = deque(maxlen=max_samples)
        self.count = 0
        self.sum = 0.0

    @property
    def max_samples(self) -> int:
        return self.samples.maxlen

    def observe(self, v: float) -> None:
        v = float(v)
        self.samples.append(v)
        self.count += 1
        self.sum += v

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile over the retained window; None if empty."""
        if not self.samples:
            return None
        s = sorted(self.samples)
        rank = math.ceil(q * len(s))               # nearest-rank definition
        return s[min(len(s) - 1, max(0, rank - 1))]

    def sample_lines(self) -> list[str]:
        lines = []
        for q in self.QUANTILES:
            p = self.percentile(q)
            if p is not None:
                lines.append(
                    f"{_series_name(self.name, self.labels, {'quantile': q})}"
                    f" {_fmt(p)}")
        lines += [
            f"{_series_name(self.name + '_sum', self.labels)} {_fmt(self.sum)}",
            f"{_series_name(self.name + '_count', self.labels)} {self.count}"]
        return lines

    def expose(self) -> list[str]:
        return self._head("summary") + self.sample_lines()


class MetricsRegistry:
    """(family, labels) -> metric map with get-or-create accessors and a
    grouped text dump.  The family name pins the metric type across every
    label set."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}   # series name -> metric
        self._families: dict[str, type] = {}     # family name -> type

    def _get(self, name: str, cls, help: str, labels: dict | None,
             **kw):
        fam = self._families.get(name)
        if fam is not None and fam is not cls:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{fam.__name__}, not {cls.__name__}")
        key = _series_name(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, help, labels=labels, **kw)
            self._metrics[key] = m
            self._families.setdefault(name, cls)
        return m

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._get(name, Counter, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._get(name, Gauge, help, labels)

    def histogram(self, name: str, help: str = "",
                  max_samples: int = 8192,
                  labels: dict | None = None) -> Histogram:
        h = self._get(name, Histogram, help, labels,
                      max_samples=max_samples)
        if h.max_samples != max_samples:
            # a silently ignored window conflict would silently change
            # what the quantiles mean — fail like the type-mismatch path
            raise ValueError(
                f"histogram {h.series!r} already registered with "
                f"max_samples={h.max_samples}, requested {max_samples}")
        return h

    def get(self, name: str, labels: dict | None = None):
        return self._metrics.get(_series_name(name, labels))

    def expose(self) -> str:
        """Prometheus-style text exposition.  Series are grouped per
        metric family: one ``# HELP``/``# TYPE`` pair, then every label
        set's samples."""
        lines: list[str] = []
        by_family: dict[str, list[_Metric]] = {}
        for key in sorted(self._metrics):
            m = self._metrics[key]
            by_family.setdefault(m.name, []).append(m)
        for fam in sorted(by_family):
            members = by_family[fam]
            kinds = {Counter: "counter", Gauge: "gauge",
                     Histogram: "summary"}
            lines += members[0]._head(kinds[type(members[0])])
            for m in members:
                lines.extend(m.sample_lines())
        return "\n".join(lines) + ("\n" if lines else "")

    def to_dict(self) -> dict:
        out: dict[str, object] = {}
        for key, m in self._metrics.items():
            if isinstance(m, Histogram):
                out[key] = {
                    "count": m.count, "sum": m.sum,
                    **{f"p{int(q * 100)}": m.percentile(q)
                       for q in m.QUANTILES},
                }
            else:
                out[key] = m.value
        return out
