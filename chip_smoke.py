#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass:

1. device — the card's name and power limit (nvidia-smi);
2. build  — every CUDA source under src/repro_torch/kernels/csrc, one
   `nvcc` each, all started together;
3. kernels — each fused-timestep kernel against its plain torch version
   on the card, at the three layer shapes of the paper's network
   (configs/snn_chip.py ARCH: 2312-4096-1024-10) with a batch of 32, over
   input densities 0, 0.02, 0.10 and 1.0, random v / elapsed, both
   `all_nonzero` settings (a codebook with a zero level when False) and
   both update modes; then their times beside the plain version's, a
   `torch.matmul` of the same product and the device-memory bound;
4. main path — `ChipSimulator(quantize(ARCH weights), engine="fused")
   .run_batch` at B=32, T=20, Bernoulli(0.10) input: exactly 60
   codebook-kernel launches, spike totals per layer within 0.1% and
   pJ/SOP within 1e-3 of the port's compiled engine, samples/s; then a
   float ARCH simulator for T=2 through the dense kernel (6 launches).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Exits non-zero, with no result line, when
no CUDA card is present or any phase fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
BATCH = 32
DENSITIES = (0.0, 0.02, 0.10, 1.0)
TIME_DENSITY = 0.10            # engine_bench's NMNIST-like input density
H100_BYTES_PER_S = 3.35e12     # H100 SXM device memory
H100_F32_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
V_ATOL = V_RTOL = 1e-5         # kernel sums over set bits in k order, the
                               # plain version is a matmul: rounding differs
TIE = 1e-4                     # a spike may flip where |v_int - theta| < TIE
SPIKE_REL_TOL = 1e-3           # fused vs compiled spike totals per layer
PJ_REL_TOL = 1e-3              # fused vs compiled pJ/SOP


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _case(rng, m, k, n, density, codebook, all_nonzero, dev):
    """Inputs of one layer-step; a zero level exists unless all_nonzero."""
    import torch

    from repro_torch.core import zspe as Z

    kw = Z.spike_word_count(k)
    kp = kw * Z.SPIKE_WORD_BITS
    s = (rng.random((m, k)) < density).astype(np.float32)
    levels = np.sort(rng.normal(0, 2.0 / np.sqrt(k), 16)).astype(np.float32)
    if all_nonzero:
        levels[levels == 0] = 1e-3
    else:
        levels[np.argmin(np.abs(levels))] = 0.0
    idx = np.zeros((kp, n), np.int8)
    idx[:k] = rng.integers(0, 16, (k, n))
    cbw = np.broadcast_to(levels[:, None], (16, n)).copy()
    dense = np.zeros((kp, n), np.float32)
    dense[:k] = levels[idx[:k]]
    t = dict(
        packed=Z.pack_spike_words(torch.as_tensor(s, device=dev)),
        v=torch.as_tensor(rng.normal(0.5, 0.4, (m, n)).astype(np.float32),
                          device=dev),
        elapsed=torch.as_tensor(rng.integers(0, 6, (m, n)).astype(np.int32),
                                device=dev))
    if codebook:
        t.update(w0=torch.as_tensor(idx, device=dev),
                 cbw=torch.as_tensor(cbw, device=dev))
    else:
        t.update(w0=torch.as_tensor(dense, device=dev), cbw=None)
    return t


def _plain_v_int(c, partial_update, leak=0.9):
    """The plain version's integrated potential v * decay + current (the
    quantity the threshold compares), for the tie exemption."""
    from repro_torch.kernels.fused_timestep import (_dequant_columns,
                                                    _unpack_words)

    s, _ = _unpack_words(c["packed"])
    w = _dequant_columns(c["w0"], c["cbw"]) if c["cbw"] is not None \
        else c["w0"]
    decay = leak ** (c["elapsed"] + 1).float() if partial_update else leak
    return c["v"] * decay + s @ w


def _launch(c, kernel_name, all_nonzero, partial_update, v=None, el=None):
    """One kernel call on case `c`; v / elapsed are cloned unless given."""
    from repro_torch.kernels import fused_timestep as FT

    v = c["v"].clone() if v is None else v
    el = c["elapsed"].clone() if el is None else el
    kw = dict(threshold=1.0, leak=0.9, reset=0.0,
              partial_update=partial_update, all_nonzero=all_nonzero)
    if kernel_name == "fused_timestep_codebook":
        return FT.fused_timestep_codebook(c["packed"], c["w0"], c["cbw"], v,
                                          el, **kw)
    return FT.fused_timestep_dense(c["packed"], c["w0"], v, el, **kw)


def _plain(c, all_nonzero, partial_update):
    from repro_torch.kernels import fused_timestep as FT

    return FT.fused_timestep_plain(
        c["packed"], c["w0"], c["cbw"], c["v"], c["elapsed"], threshold=1.0,
        leak=0.9, reset=0.0, partial_update=partial_update,
        all_nonzero=all_nonzero)


def compare_case(c, kernel_name, all_nonzero, partial_update,
                 desc: str = "") -> float:
    """Kernel vs plain on one case; raises on disagreement, returns the
    max |v' difference| where no spike flipped."""
    import torch

    got = _launch(c, kernel_name, all_nonzero, partial_update)
    kernel_name = f"{kernel_name} {desc}"
    want = _plain(c, all_nonzero, partial_update)
    torch.cuda.synchronize()
    names = ("v'", "elapsed'", "spikes", "touched", "nnz", "empty words")
    for i in (1, 3, 4, 5):                      # integers: exact
        if not torch.equal(got[i], want[i]):
            bad = int((got[i] != want[i]).sum())
            raise AssertionError(f"{kernel_name}: {names[i]} differs in "
                                 f"{bad} elements")
    v_int = _plain_v_int(c, partial_update)
    flip = got[2] != want[2]
    if partial_update:
        flip_ok = (want[3] > 0) & ((v_int - 1.0).abs() < TIE)
    else:
        flip_ok = (v_int - 1.0).abs() < TIE
    if bool((flip & ~flip_ok).any()):
        raise AssertionError(
            f"{kernel_name}: {int((flip & ~flip_ok).sum())} spikes differ "
            f"away from the threshold")
    keep = ~flip
    dv = (got[0] - want[0]).abs()
    lim = V_ATOL + V_RTOL * want[0].abs()
    if bool((dv > lim)[keep].any()):
        raise AssertionError(f"{kernel_name}: v' off by up to "
                             f"{float(dv[keep].max())}")
    return float(dv[keep].max()) if bool(keep.any()) else 0.0


def _time_eager_ms(fn, reps: int = 20) -> float:
    """CUDA-event time per call of `fn` issued from Python; where the host
    issues slower than the card runs, this is the host's rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_graph_ms(fn, reps: int = 50) -> float:
    """Device time per call: `reps` calls captured in one CUDA graph and
    replayed, so no host launch cost is in the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _bound(c, codebook: bool) -> tuple[float, str]:
    """Least time for one call on these inputs: each input read once, each
    output written once (only the weight rows a spike reaches), or the f32
    adds of the set bits, whichever is larger."""
    from repro_torch.kernels.fused_timestep import _unpack_words

    s, nnz = _unpack_words(c["packed"])
    m, n = c["v"].shape
    rows_needed = int((s.sum(0) > 0).sum())
    w_bytes = rows_needed * n * (1 if codebook else 4)
    if codebook:
        w_bytes += c["cbw"].numel() * 4
    state = m * n * 4 * 2 * 2            # v and elapsed, read + written
    outs = m * n * 4 * 2 + m * 4 * 2     # spikes, touched, nnz, empty words
    nbytes = c["packed"].numel() * 2 + w_bytes + state + outs
    ops = int(nnz.sum()) * n
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(arch, seed: int) -> dict:
    """Compare both kernels with their plain versions over the cases, then
    time them at the main path's shapes.  Returns per-kernel results."""
    import torch

    from repro_torch.kernels.fused_timestep import _dequant_columns, \
        _unpack_words

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    shapes = [(arch.layer_sizes[i], arch.layer_sizes[i + 1])
              for i in range(len(arch.layer_sizes) - 1)]
    results = {}
    for name, codebook in (("fused_timestep_codebook", True),
                           ("fused_timestep_dense", False)):
        err = 0.0
        n_cases = 0
        for k, n in shapes:
            for density in DENSITIES:
                for all_nonzero in (False, True):
                    modes = (True, False) if density == TIME_DENSITY \
                        else (True,)
                    for partial_update in modes:
                        c = _case(rng, BATCH, k, n, density, codebook,
                                  all_nonzero, dev)
                        desc = (f"[K={k} N={n} density={density} "
                                f"all_nonzero={all_nonzero} "
                                f"partial_update={partial_update}]")
                        err = max(err, compare_case(c, name, all_nonzero,
                                                    partial_update, desc))
                        n_cases += 1
        ms = plain_ms = lib_ms = bound_ms = 0.0
        bound_parts = {"bytes": 0.0, "operations": 0.0}
        per_shape = []
        for k, n in shapes:
            c = _case(rng, BATCH, k, n, TIME_DENSITY, codebook, False, dev)
            v, el = c["v"].clone(), c["elapsed"].clone()

            def run_kernel():
                _launch(c, name, False, True, v, el)
            s, _ = _unpack_words(c["packed"])
            w = _dequant_columns(c["w0"], c["cbw"]) if codebook else c["w0"]
            t_k = _time_graph_ms(run_kernel)
            t_eager = _time_eager_ms(run_kernel)
            t_p = _time_eager_ms(lambda: _plain(c, False, True))
            t_l = _time_graph_ms(lambda: torch.matmul(s, w))
            b, by = _bound(c, codebook)
            ms += t_k
            plain_ms += t_p
            lib_ms += t_l
            bound_ms += b
            bound_parts[by] += b
            per_shape.append({"shape": [BATCH, k, n], "ms": t_k,
                              "eager_ms": t_eager,
                              "plain_ms": t_p, "library_ms": t_l,
                              "bound_ms": b, "bound_by": by})
        log(f"kernel {name}: {n_cases} cases agree, max |dv'| {err:.3g}; "
            f"per shape {json.dumps(per_shape)}")
        results[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": max(bound_parts, key=bound_parts.get)}
    return results


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def _arch_weights(arch, seed):
    rng = np.random.default_rng(seed)
    sizes = arch.layer_sizes
    return [rng.normal(0, 2.0 / np.sqrt(sizes[i]),
                       (sizes[i], sizes[i + 1])).astype(np.float32)
            for i in range(len(sizes) - 1)]


def _layer_spikes(sim, trains) -> np.ndarray:
    ys, _ = sim.array_engine().run_raw(trains)
    return ys["fired"].sum(dim=(0, 1)).double().cpu().numpy()


def _check_against_compiled(fused, compiled, trains, what: str) -> None:
    f_sp = _layer_spikes(fused, trains)
    c_sp = _layer_spikes(compiled, trains)
    rel = np.abs(f_sp - c_sp) / np.maximum(c_sp, 1.0)
    log(f"{what}: spikes per layer fused {f_sp.tolist()} compiled "
        f"{c_sp.tolist()} (max rel {rel.max():.3g})")
    if rel.max() > SPIKE_REL_TOL:
        raise AssertionError(f"{what}: fused and compiled spike totals "
                             f"differ by {rel.max():.3g} relative")
    _, rf = fused.run_batch(trains)
    _, rc = compiled.run_batch(trains)
    pf = np.array([r.pj_per_sop for r in rf])
    pc = np.array([r.pj_per_sop for r in rc])
    prel = np.abs(pf - pc) / pc
    log(f"{what}: pJ/SOP fused {pf.mean():.6f} compiled {pc.mean():.6f} "
        f"(max rel {prel.max():.3g})")
    if prel.max() > PJ_REL_TOL:
        raise AssertionError(f"{what}: pJ/SOP differs by {prel.max():.3g}")


def _device_breakdown(fn, wall_ms: float) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler), and
    the card's idle share against the unprofiled wall time `wall_ms`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
    busy = sum(by_kernel.values())
    if busy == 0:
        log("device breakdown: the profiler saw no device time — not "
            "measured")
        return {}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    fused = sum(ms for name, ms in by_kernel.items()
                if "fused_timestep_kernel" in name)
    out = {"device_busy_ms": busy, "fused_kernel_ms": fused,
           "idle_share": max(0.0, 1.0 - busy / wall_ms),
           "device_kernels": len(by_kernel)}
    log(f"device breakdown of one run (profiled): {json.dumps(out)}; "
        f"top kernels (ms): {json.dumps(top)}")
    return out


def main_path(arch, seed: int) -> dict:
    import torch

    from repro_torch import ChipSimulator, CodebookConfig, quantize
    from repro_torch.kernels import fused_timestep as FT

    dev = DEVICE
    weights = _arch_weights(arch, seed)
    rng = np.random.default_rng(seed + 1)
    trains = (rng.random((BATCH, arch.timesteps, arch.layer_sizes[0]))
              < TIME_DENSITY).astype(np.float32)
    qcfg = CodebookConfig(n_levels=arch.weight_levels,
                          bit_width=arch.weight_bits, zero_level=True)
    stage = {}
    t0 = time.perf_counter()
    qws = [quantize(w, qcfg, device=dev) for w in weights]
    torch.cuda.synchronize()
    stage["quantize_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = ChipSimulator(qws, engine="fused", freq_hz=arch.freq_hz,
                        threshold=arch.threshold, leak=arch.leak, device=dev)
    stage["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = sim.fused_engine()
    stage["lower_s"] = time.perf_counter() - t0
    if eng.codebook_layers != len(weights):
        raise AssertionError(f"only {eng.codebook_layers} layers lowered to "
                             f"codebook mode")
    trains_dev = torch.as_tensor(trains, device=dev)

    FT.reset_launches()
    counts, reports = sim.run_batch(trains_dev)
    torch.cuda.synchronize()
    launches = dict(FT.launches)
    want = arch.timesteps * len(weights)
    if launches != {"fused_timestep_codebook": want,
                    "fused_timestep_dense": 0}:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{want} codebook launches")
    counts_np = counts.cpu().numpy()
    if counts_np.shape != (BATCH, arch.layer_sizes[-1]) \
            or not np.isfinite(counts_np).all() or counts_np.min() < 0:
        raise AssertionError(f"bad output counts {counts_np.shape}")
    pj = np.array([r.pj_per_sop for r in reports])
    if not np.isfinite(pj).all() or pj.min() <= 0:
        raise AssertionError(f"bad pJ/SOP {pj}")
    log(f"main path: {launches}, outputs {counts_np.shape} total "
        f"{counts_np.sum():.0f}, pJ/SOP mean {pj.mean():.6f}")

    compiled = ChipSimulator(qws, engine="compiled", freq_hz=arch.freq_hz,
                             threshold=arch.threshold, leak=arch.leak,
                             mapping=sim.mapping, device=dev)
    _check_against_compiled(sim, compiled, trains_dev, "quantized ARCH")

    def timed(fn, reps=5):
        fn()                                  # warmup
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out) * 1e3

    run_ms = timed(lambda: sim.run_batch(trains_dev))
    raw_ms = timed(lambda: eng.run_raw(trains_dev))
    comp_ms = timed(lambda: compiled.run_batch(trains_dev))
    perf = {"ms_per_run": run_ms, "samples_per_s": BATCH / run_ms * 1e3,
            "run_raw_ms": raw_ms, "price_ms": run_ms - raw_ms,
            "compiled_ms_per_run": comp_ms, **stage}
    log(f"main path timing (median of 5): {json.dumps(perf)}")
    perf.update(_device_breakdown(lambda: sim.run_batch(trains_dev), run_ms))

    # a float simulator takes the dense kernel
    fsim = ChipSimulator(weights, engine="fused", freq_hz=arch.freq_hz,
                         threshold=arch.threshold, leak=arch.leak,
                         mapping=sim.mapping, device=dev)
    if fsim.fused_engine().codebook_layers != 0:
        raise AssertionError("float simulator lowered to codebook mode")
    short = trains_dev[:, :2].contiguous()
    FT.reset_launches()
    fsim.run_batch(short)
    torch.cuda.synchronize()
    dense_launches = dict(FT.launches)
    if dense_launches != {"fused_timestep_codebook": 0,
                          "fused_timestep_dense": 2 * len(weights)}:
        raise AssertionError(f"float run launches {dense_launches}")
    fcomp = ChipSimulator(weights, engine="compiled", freq_hz=arch.freq_hz,
                          threshold=arch.threshold, leak=arch.leak,
                          mapping=sim.mapping, device=dev)
    _check_against_compiled(fsim, fcomp, short, "float ARCH, T=2")
    return {"launches": {**launches, "fused_timestep_dense":
                         dense_launches["fused_timestep_dense"]},
            "perf": perf}


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repo checkout)
    from repro_torch.configs.snn_chip import ARCH
    from repro_torch.kernels import build

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    nvcc_logs = build.build_all()
    log(f"build: {sorted(nvcc_logs)} in {time.perf_counter() - t0:.1f} s")
    for src, text in nvcc_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # 3. kernels
    kern = kernel_phase(ARCH, args.seed)

    # 4. main path
    mp = main_path(ARCH, args.seed)

    # 5. kernels line, then the result
    replaces = {
        "fused_timestep_codebook":
            "src/repro/kernels/fused_timestep.py:231",
        "fused_timestep_dense": "src/repro/kernels/fused_timestep.py:266"}
    line = {"kernels": [
        {"name": kname, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_timestep.cu",
         "replaces": replaces[kname], "launches": mp["launches"][kname],
         **kern[kname]} for kname in replaces]}
    for entry in line["kernels"]:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} never ran on the main "
                                 f"path")
    log(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
