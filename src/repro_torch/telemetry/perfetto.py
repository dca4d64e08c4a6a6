"""Chrome-trace / Perfetto JSON export of a ChipTrace.

Port of `repro.telemetry.perfetto` (numpy, as in the reference).

Renders one traced sample as a timeline loadable in https://ui.perfetto.dev
(or chrome://tracing): each physical core is a thread inside its domain's
process, every core-slice layer-step is a complete ("ph": "X") span, the
NoC track carries the per-step M/M/1 contention-wait spans plus a
bottleneck-occupancy counter, and the RISC-V host track replays the
EnuProgram (NPARAM.INIT/CORE.EN/NET.START prologue, one TS.SYNC sleep
span per timestep, NET.WAIT + OBUF.READ epilogue) on its own 16 MHz
clock — the DMA/host phases of soc.EnuProgram.timeline.

Timestamps are microseconds (the Chrome trace unit): chip cycles divide
by `freq_hz`; the host prologue shifts chip t=0 so spans never overlap
backwards.  Within a (pid, tid) track events are emitted in
non-decreasing ts order — tests assert monotonicity after a
json.loads round trip.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.core import energy as E
from repro_torch.core import noc as NOC
from repro_torch.telemetry.trace import ChipTrace

NOC_PID = 1000          # synthetic process ids for the non-core tracks
RISCV_PID = 1001
CPU_CYCLES_PER_INSTR = 40.0
CPU_FREQ_HZ = 16e6


def to_perfetto(trace: ChipTrace, sample: int = 0) -> dict:
    """One traced sample -> a Chrome-trace JSON document (dict)."""
    if not 0 <= sample < trace.batch:
        raise ValueError(f"sample {sample} out of range for "
                         f"batch {trace.batch}")
    b = sample
    us_per_cycle = 1e6 / trace.freq_hz
    instr_us = CPU_CYCLES_PER_INSTR / CPU_FREQ_HZ * 1e6

    events: list[dict] = []

    def meta(pid, name, tid=None):
        ev = {"ph": "M", "pid": pid,
              "name": "process_name" if tid is None else "thread_name",
              "args": {"name": name}}
        if tid is not None:
            ev["tid"] = tid
        events.append(ev)

    def span(pid, tid, name, ts, dur, args=None):
        ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
              "ts": round(float(ts), 4), "dur": round(float(dur), 4),
              "cat": "chip"}
        if args:
            ev["args"] = args
        events.append(ev)

    domains = sorted({int(c) // NOC.DOMAIN_STRIDE for c in trace.slice_core})
    for d in domains:
        meta(d, f"chip domain {d}")
    for cid in trace.core_ids:
        meta(int(cid) // NOC.DOMAIN_STRIDE, f"core {int(cid)}", tid=int(cid))
    meta(NOC_PID, "noc")
    meta(NOC_PID, "contention", tid=0)
    meta(RISCV_PID, "riscv host")
    meta(RISCV_PID, "enu", tid=0)

    # host prologue on the RISC-V clock; the chip starts after it
    t = 0.0
    for op in ("NPARAM.INIT", "CORE.EN", "NET.START"):
        span(RISCV_PID, 0, op, t, instr_us)
        t += instr_us
    t0_chip = t

    # per-core slice ordering: within a step a core executes its slices
    # in layer order (the pipeline's layer-sequential schedule)
    order = np.argsort(trace.slice_layer, kind="stable")
    step_wall = trace.core_wall[b] + trace.contention_cycles[b]   # (T,)
    step_start = t0_chip + np.concatenate(
        ([0.0], np.cumsum(step_wall)[:-1])) * us_per_cycle

    for t_i in range(trace.steps):
        ts0 = float(step_start[t_i])
        core_cursor = {int(c): ts0 for c in trace.core_ids}
        for s in order:
            cid = int(trace.slice_core[s])
            dur = float(trace.cycles[b, t_i, s]) * us_per_cycle
            span(cid // NOC.DOMAIN_STRIDE, cid, f"L{int(trace.slice_layer[s]) + 1}",
                 core_cursor[cid], dur,
                 args={"fired": float(trace.fired[b, t_i, s]),
                       "touched": float(trace.touched[b, t_i, s]),
                       "neurons": int(trace.slice_neurons[s])})
            core_cursor[cid] += dur
        events.append({
            "ph": "C", "pid": NOC_PID, "tid": 0,
            "name": "bottleneck router load", "ts": round(ts0, 4),
            "args": {"spikes": float(trace.router_load[b, t_i].max())}})
        wait = float(trace.contention_cycles[b, t_i]) * us_per_cycle
        if wait > 0:
            span(NOC_PID, 0, "contention wait",
                 ts0 + float(trace.core_wall[b, t_i]) * us_per_cycle, wait,
                 args={"bottleneck_load":
                       float(trace.router_load[b, t_i].max())})
        span(RISCV_PID, 0, f"TS.SYNC t={t_i}", ts0,
             float(step_wall[t_i]) * us_per_cycle,
             args={"ctrl_cycles": E.RISCV_CTRL_CYCLES_PER_STEP})

    t_end = float(step_start[-1] + step_wall[-1] * us_per_cycle)
    span(RISCV_PID, 0, "NET.WAIT", t_end, instr_us)
    span(RISCV_PID, 0, "OBUF.READ", t_end + instr_us, instr_us)

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "sample": b,
            "freq_hz": trace.freq_hz,
            "steps": trace.steps,
            "wall_cycles": float(trace.wall_cycles()[b]),
        },
    }


def export_perfetto(trace: ChipTrace, path: str, sample: int = 0) -> str:
    """Write the Chrome-trace JSON for `sample` to `path`; returns the
    serialized string (tests round-trip it through json.loads)."""
    doc = to_perfetto(trace, sample=sample)
    text = json.dumps(doc)
    with open(path, "w") as f:
        f.write(text)
    return text
