"""Chip-level telemetry of the port: opt-in engine tracing, hierarchical
energy/cycle attribution, Perfetto timeline export, and the serving
metrics registry.  Port of `repro.telemetry`.

    from repro_torch.telemetry import TraceConfig
    sim = ChipSimulator(weights, trace=TraceConfig(enabled=True))
    sim.run_batch(trains)
    trace = sim.last_trace()                 # ChipTrace, schema-identical
                                             # across both engines
    prof = aggregate.profile(trace)          # core/router/domain/chip
    perfetto.export_perfetto(trace, "trace.json")
"""
from repro_torch.telemetry.aggregate import (format_profile, profile,
                                             profile_summary)
from repro_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                           MetricsRegistry)
from repro_torch.telemetry.perfetto import export_perfetto, to_perfetto
from repro_torch.telemetry.trace import ChipTrace, TraceConfig, build_trace

__all__ = [
    "ChipTrace", "TraceConfig", "build_trace",
    "profile", "profile_summary", "format_profile",
    "to_perfetto", "export_perfetto",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
]
