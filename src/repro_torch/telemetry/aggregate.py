"""Hierarchical trace aggregation: slice -> core -> domain -> chip.

Port of `repro.telemetry.aggregate` (numpy, as in the reference).

The core energy model is *affine in spike density* —

    core_pj = pj_per_sop(s) * nominal
            = alpha*a * nominal + (alpha*b + gamma) * performed
              [+ delta_upd * nominal when full-update]

— so per-slice attribution from the traced nominal/performed counts is
EXACT: summing the per-slice terms reproduces `energy.price_batched`'s
chip total to float64 rounding, with no proportional-split heuristic.
NoC energy attributes to the *source* slice (the per-flow replay already
prices each source core's spikes separately); RISC-V energy is a
chip-global duty-cycle term and stays one row.

`profile(trace)` returns the attribution tables as plain dicts;
`format_profile` renders the text report the reference's
scripts/profile_report.py prints — per-layer, per-core and top-k hot-router views of where the
cycles and picojoules went.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import energy as E
from repro_torch.core import noc as NOC
from repro_torch.telemetry.trace import ChipTrace


def _node_kind(node: int) -> str:
    r = int(node) % NOC.DOMAIN_STRIDE
    if r < NOC.N_ROUTERS:
        return "router"
    if r < NOC.N_NODES:
        return "core"
    return "level2"


def _core_pj_per_slice(trace: ChipTrace, core: E.CoreEnergyModel
                       ) -> np.ndarray:
    """(S,) exact per-slice core energy over the whole traced batch."""
    n_pres = np.asarray(trace.layer_sizes[:-1], np.float64)
    slice_n = trace.slice_neurons.astype(np.float64)
    nominal = (n_pres[trace.slice_layer] * slice_n
               * trace.batch * trace.steps)
    if trace.zero_skip:
        # performed SOPs of slice s = sum_t nnz[layer(s), t] * slice_n
        nnz_sum = trace.nnz.sum(axis=(0, 1))            # (L,)
        performed = nnz_sum[trace.slice_layer] * slice_n
    else:
        performed = nominal
    pj = core.alpha * core.a * nominal \
        + (core.alpha * core.b + core.gamma) * performed
    if not trace.partial_update:
        pj += core.delta_upd * nominal
    return pj


def profile(trace: ChipTrace,
            core_model: E.CoreEnergyModel | None = None,
            riscv: E.RiscvPowerModel | None = None) -> dict:
    """Aggregate a ChipTrace into chip/layer/core/domain/router tables.

    Totals are summed over the traced batch; `share` columns are each
    row's fraction of the chip's core+NoC energy.
    """
    core_model = core_model or E.calibrate_core()
    riscv = riscv or E.RiscvPowerModel()

    slice_pj = _core_pj_per_slice(trace, core_model)     # (S,)
    slice_noc_pj = trace.noc_pj.sum(axis=(0, 1))         # (S,)
    slice_noc_hops = trace.noc_hops.sum(axis=(0, 1))
    slice_fired = trace.fired.sum(axis=(0, 1))
    slice_touched = trace.touched.sum(axis=(0, 1))
    slice_cycles = trace.cycles.sum(axis=(0, 1))

    n_pres = np.asarray(trace.layer_sizes[:-1], np.float64)
    nnz_sum = trace.nnz.sum(axis=(0, 1))                 # (L,)
    B, T = trace.batch, trace.steps
    wall = trace.wall_cycles()                           # (B,)
    wall_total = float(wall.sum())
    contention_total = float(trace.contention_cycles.sum())

    # RISC-V: same duty expression as energy.price_batched, per sample
    duty = np.minimum(1.0, T * E.RISCV_CTRL_CYCLES_PER_STEP
                      / np.maximum(wall, 1.0))
    riscv_pj = float((riscv.average_power_mw(duty) * 1e-3
                      * wall / trace.freq_hz * 1e12).sum())

    core_pj_total = float(slice_pj.sum())
    noc_pj_total = float(slice_noc_pj.sum())
    total_pj = core_pj_total + noc_pj_total + riscv_pj
    attributable = max(core_pj_total + noc_pj_total, 1e-300)
    nominal_total = float((n_pres * np.asarray(
        trace.layer_sizes[1:], np.float64)).sum() * B * T)
    performed_total = float((nnz_sum * np.asarray(
        trace.layer_sizes[1:], np.float64)).sum())

    layers = []
    for li in range(trace.n_layers):
        sel = trace.slice_layer == li
        pj = float(slice_pj[sel].sum())
        npj = float(slice_noc_pj[sel].sum())
        nominal_li = float(n_pres[li]) * trace.layer_sizes[li + 1] * B * T
        layers.append({
            "layer": li + 1,
            "n_pre": int(trace.layer_sizes[li]),
            "n_post": int(trace.layer_sizes[li + 1]),
            "slices": int(sel.sum()),
            "spikes_in": float(nnz_sum[li]),
            "fired": float(slice_fired[sel].sum()),
            "touched": float(slice_touched[sel].sum()),
            "sparsity": 1.0 - float(nnz_sum[li]) / max(
                float(n_pres[li]) * B * T, 1.0),
            "cycles": float(slice_cycles[sel].sum()),
            "core_pj": pj,
            "noc_pj": npj,
            "pj_per_sop": (pj + npj) / max(nominal_li, 1.0),
            "skip_words": (None if trace.skip_words is None
                           else float(trace.skip_words[..., li].sum())),
            "weight_writes": (None if trace.weight_writes is None
                              else float(
                                  trace.weight_writes[..., li].sum())),
            "share": (pj + npj) / attributable,
        })

    cores = []
    for ci, cid in enumerate(trace.core_ids):
        sel = trace.slice_core == cid
        pj = float(slice_pj[sel].sum())
        npj = float(slice_noc_pj[sel].sum())
        cores.append({
            "core_id": int(cid),
            "domain": int(cid) // NOC.DOMAIN_STRIDE,
            "layers": sorted(int(l) + 1
                             for l in set(trace.slice_layer[sel])),
            "neurons": int(trace.slice_neurons[sel].sum()),
            "fired": float(slice_fired[sel].sum()),
            "touched": float(slice_touched[sel].sum()),
            "cycles": float(trace.core_cycles[..., ci].sum()),
            "core_pj": pj,
            "noc_pj": npj,
            "share": (pj + npj) / attributable,
        })
    cores.sort(key=lambda r: r["core_pj"] + r["noc_pj"], reverse=True)

    domains = []
    for d in sorted({r["domain"] for r in cores}):
        rows = [r for r in cores if r["domain"] == d]
        domains.append({
            "domain": d,
            "cores": len(rows),
            "core_pj": sum(r["core_pj"] for r in rows),
            "noc_pj": sum(r["noc_pj"] for r in rows),
            "share": sum(r["share"] for r in rows),
        })

    load_total = trace.router_load.sum(axis=(0, 1))      # (n_nodes,)
    load_sum = max(float(load_total.sum()), 1e-300)
    routers = [{
        "node": int(n),
        "kind": _node_kind(n),
        "load": float(load_total[n]),
        "share": float(load_total[n]) / load_sum,
    } for n in np.argsort(load_total)[::-1] if load_total[n] > 0]

    return {
        "batch": B,
        "steps": T,
        "chip": {
            "core_pj": core_pj_total,
            "noc_pj": noc_pj_total,
            "riscv_pj": riscv_pj,
            "total_pj": total_pj,
            "wall_cycles": wall_total,
            "contention_cycles": contention_total,
            "contention_share": contention_total / max(wall_total, 1e-300),
            "nominal_sops": nominal_total,
            "performed_sops": performed_total,
            "sparsity": 1.0 - performed_total / max(nominal_total, 1.0),
            "pj_per_sop": total_pj / max(nominal_total, 1.0),
            "spike_words_skipped": (
                None if trace.skip_words is None
                else float(trace.skip_words.sum())),
            "weight_writes": (
                None if trace.weight_writes is None
                else float(trace.weight_writes.sum())),
        },
        "layers": layers,
        "cores": cores,
        "domains": domains,
        "routers": routers,
    }


def _fmt_row(cols, widths) -> str:
    return "  ".join(f"{c:>{w}}" for c, w in zip(cols, widths))


def format_profile(prof: dict, top_k: int = 8) -> str:
    """Render `profile()` output as the attribution text report."""
    c = prof["chip"]
    lines = [
        f"chip profile — batch {prof['batch']} x T={prof['steps']}",
        f"  energy   {c['total_pj']:.1f} pJ  (core {c['core_pj']:.1f} | "
        f"noc {c['noc_pj']:.1f} | riscv {c['riscv_pj']:.1f})   "
        f"{c['pj_per_sop']:.4f} pJ/SOP",
        f"  wall     {c['wall_cycles']:.0f} cycles  (contention "
        f"{c['contention_cycles']:.1f}, {c['contention_share']:.2%})",
        f"  sparsity {c['sparsity']:.4f}"
        + ("" if c["spike_words_skipped"] is None else
           f"   skip-words {c['spike_words_skipped']:.0f}"),
        "",
        "per-layer",
    ]
    w = (5, 11, 10, 10, 9, 12, 11, 9, 7)
    lines.append("  " + _fmt_row(
        ("layer", "shape", "spikes_in", "fired", "sparsity", "cycles",
         "core_pj", "noc_pj", "share"), w))
    for r in prof["layers"]:
        lines.append("  " + _fmt_row(
            (r["layer"], f"{r['n_pre']}x{r['n_post']}",
             f"{r['spikes_in']:.0f}", f"{r['fired']:.0f}",
             f"{r['sparsity']:.3f}", f"{r['cycles']:.0f}",
             f"{r['core_pj']:.1f}", f"{r['noc_pj']:.2f}",
             f"{r['share']:.1%}"), w))
    lines += ["", f"per-core (top {top_k} by energy)"]
    w = (5, 7, 7, 9, 10, 12, 11, 9, 7)
    lines.append("  " + _fmt_row(
        ("core", "domain", "layers", "fired", "touched", "cycles",
         "core_pj", "noc_pj", "share"), w))
    for r in prof["cores"][:top_k]:
        lines.append("  " + _fmt_row(
            (r["core_id"], r["domain"],
             ",".join(map(str, r["layers"])), f"{r['fired']:.0f}",
             f"{r['touched']:.0f}", f"{r['cycles']:.0f}",
             f"{r['core_pj']:.1f}", f"{r['noc_pj']:.2f}",
             f"{r['share']:.1%}"), w))
    lines += ["", f"hot routers (top {top_k} by spike occupancy)"]
    w = (5, 7, 12, 7)
    lines.append("  " + _fmt_row(("node", "kind", "load", "share"), w))
    for r in prof["routers"][:top_k]:
        lines.append("  " + _fmt_row(
            (r["node"], r["kind"], f"{r['load']:.0f}",
             f"{r['share']:.1%}"), w))
    return "\n".join(lines)


def profile_summary(prof: dict, top_k: int = 4) -> dict:
    """Compact embed for DeployReport: chip totals + per-layer rows +
    the top-k cores/routers (JSON-small, gates can cite attribution)."""
    return {
        "chip": prof["chip"],
        "layers": prof["layers"],
        "top_cores": prof["cores"][:top_k],
        "top_routers": prof["routers"][:top_k],
    }
