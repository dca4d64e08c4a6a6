#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass:

1. device — the card's name and power limit (nvidia-smi);
2. build  — every CUDA source under src/repro_torch/kernels/csrc, one
   `nvcc` each, all started together; ptxas registers and spills per
   kernel, and the flash library's SASS must hold `HGMMA` (wgmma) and
   `UTMALDG` (TMA) instructions;
3. kernels — each fused-timestep kernel against its plain torch version
   on the card, at the three layer shapes of the paper's network
   (configs/snn_chip.py ARCH: 2312-4096-1024-10) with a batch of 32, over
   input densities 0, 0.02, 0.10 and 1.0, random v / elapsed, both
   `all_nonzero` settings (a codebook with a zero level when False) and
   both update modes; then their times beside the plain version's, a
   `torch.matmul` of the same product and the device-memory bound;
   Then the kernel API's kernels (zspe_spmm, codebook_matmul,
   lif_update) against their plain versions at the same layer shapes
   with M = 32 (one step), 200 (edge row tiles) and 32 x 20 = 640 rows
   (a whole run; spike densities 0, 0.02, 0.10, 1.0 and a
   tile-structured case; Gaussian f32 and bf16 x for the codebook
   product; (M, N) LIF states), and their times at M = 32 and 640.  The
   two products are held against the plain product in f64, which they
   compute (f64 sums, one rounding), not against an f32 matmul's rounding.
   The codebook product also at the edges of its plan and lookup table:
   int8 indexes outside [0, L) (negative ones, and 16 with L = 8) at the
   three layer shapes with M = 32, and shapes whose K the split does not
   divide (K = 1, 999, 1000, 4100; N = 10 and 37);
4. main path — `ChipSimulator(quantize(ARCH weights), engine="fused")
   .run_batch` at B=32, T=20, Bernoulli(0.10) input: exactly 60
   codebook-kernel launches, spike totals per layer within 0.1% and
   pJ/SOP within 1e-3 of the port's compiled engine, samples/s; then a
   float ARCH simulator for T=2 through the dense kernel (6 launches);
5. kernel-API path — the paper's network as a loop over T of
   `kernels.ops` calls at B=32, T=20: (a) `zspe_spmm` of the dequantized
   weights then `lif_update`, (b) the same with `codebook_matmul` of the
   indexes, (c) the padded `fused_timestep` of the indexes: exactly 60
   launches of each kernel per loop; every layer-step's current (against
   the f64 product) and LIF outputs held against the plain versions on the
   same inputs (loop (c)
   against `ops.fused_timestep` on the CPU); spike totals per layer
   within 0.1% of the same loop on the plain versions (a, b) and of each
   other; one `codebook_matmul` backward at layer 1 against plain
   autograd; ms per loop and the card's idle share;
6. LM serving path — (a) the flash-attention kernel against its plain
   version (B 2, H 8, S = T in {128, 1024}, hd 16 / 32 / 64 / 128, group
   1 and 4, causal and not, f32 and bf16; T > S and S > T causal; the
   served shape B 4, H 32, KV 8, S = T = 512, hd 64, bf16, and
   granite-3-8b's, the same with hd 128) and timed at both beside
   `scaled_dot_product_attention` (the kernels line reports the served
   one); (b) `Server` on granite-3-2b ARCH (40 layers, d 2048, bf16,
   random weights from --seed): 8 requests of 512 prompt tokens, 4 slots,
   16 new tokens each, exactly 80 flash launches (2 prefill batches x 40
   layers), every one on the tensor-core kernel, tokens/s, prefill and
   decode ms, peak memory, the idle share over one batch; (c) last-token
   logits of a 512-token prefill (flash route) against a 511-token
   prefill plus one decode step (plain route), and every layer's flash
   call of that prefill against the plain version on the same q / k / v.

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
RAGGED_ROWS = 200              # not a multiple of the 128-row zspe tile or
                               # of the codebook kernel's 64-row tile
DENSITIES = (0.0, 0.02, 0.10, 1.0)
TIME_DENSITY = 0.10            # engine_bench's NMNIST-like input density
H100_BYTES_PER_S = 3.35e12     # H100 SXM device memory
H100_F32_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
V_ATOL = V_RTOL = 1e-5         # kernel sums over set bits in k order, the
                               # plain version is a matmul: rounding differs
TIE = 1e-4                     # a spike may flip where |v_int - theta| < TIE
SPIKE_REL_TOL = 1e-3           # fused vs compiled spike totals per layer
PJ_REL_TOL = 1e-3              # fused vs compiled pJ/SOP
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-2   # codebook backward, as the reference's
                                    # own gradient test holds it
LIF_BYTES = 25                 # lif_update: 3 x 4 bytes read, 3 x 4 + 1
                               # (int8 `updated`) written per element


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


FUSED_INTS = {1: "elapsed'", 3: "touched", 4: "nnz", 5: "empty words"}
LIF_INTS = {1: "elapsed'", 3: "updated"}


def _assert_close(what: str, got, want) -> float:
    """Floats within V_ATOL + V_RTOL * |want|; returns the max difference."""
    d = (got.float() - want.float()).abs()
    if bool((d > V_ATOL + V_RTOL * want.float().abs()).any()):
        raise AssertionError(f"{what}: off by up to {float(d.max())}")
    return float(d.max()) if d.numel() else 0.0


def _exact_product(x, w):
    """The plain product x @ w in f64, where the inputs are exact: what
    the zspe and codebook kernels compute, since they sum in f64 and round
    once.  Their plain versions' f32 matmul rounds over up to K = 4096
    terms, and that rounding moves from run to run with the codebook the
    card's k-means finds (its `index_add_` adds in no fixed order): on an
    H100 it reached 1.47e-05 at M=640 K=4096 N=1024 density 1.0, past
    V_ATOL + V_RTOL * |want|."""
    return x.double() @ w.double()


def check_step(what: str, got, want, ints: dict, v_int, threshold=1.0,
               touched=None) -> float:
    """A LIF step's outputs (v', elapsed', spikes, ...) against the plain
    version's: the outputs named in `ints` exact, a spike may flip only
    within TIE of the threshold (and only where `touched` > 0, if given),
    v' within V_ATOL + V_RTOL * |want| where the spikes agree.  `v_int` is
    the plain integrated potential.  Returns the max |v' difference|."""
    import torch

    for i, name in ints.items():
        if not torch.equal(got[i], want[i]):
            raise AssertionError(f"{what}: {name} differs in "
                                 f"{int((got[i] != want[i]).sum())} elements")
    flip_ok = (v_int - threshold).abs() < TIE
    if touched is not None:
        flip_ok &= touched > 0
    flip = got[2] != want[2]
    if bool((flip & ~flip_ok).any()):
        raise AssertionError(
            f"{what}: {int((flip & ~flip_ok).sum())} spikes differ away "
            f"from the threshold")
    return _assert_close(f"{what} v'", got[0][~flip], want[0][~flip])


def compare_case(c, kernel_name, all_nonzero, partial_update,
                 desc: str = "") -> float:
    """Kernel vs plain on one case; raises on disagreement, returns the
    max |v' difference| where no spike flipped."""
    import torch

    got = _launch(c, kernel_name, all_nonzero, partial_update)
    want = _plain(c, all_nonzero, partial_update)
    torch.cuda.synchronize()
    return check_step(f"{kernel_name} {desc}", got, want, FUSED_INTS,
                      _plain_v_int(c, partial_update),
                      touched=want[3] if partial_update else None)


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
    return _roof(nbytes, int(nnz.sum()) * n)


def _roof(nbytes: int, ops: int) -> tuple[float, str]:
    """The larger of bytes over the memory rate and f32 operations over
    the f32 rate, in ms, and which of the two it is."""
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


def _api_spikes(rng, m: int, k: int, density, dev, tile=(128, 128)):
    """(m, K) f32 spikes: one step's (B, K) spikes (m = 32) or a run's
    (B, T, K) trains seen through the kernel API's leading dims.
    `density=None` is tile-structured: about half of the `tile` spike
    tiles, and always the first, hold no spike, the rest Bernoulli(0.10),
    so the zspe skip counters are nonzero at full width."""
    import torch

    if density is None:
        bm, bk = tile
        keep = rng.random((-(-m // bm), -(-k // bk))) < 0.5
        keep[0, 0] = False
        mask = np.repeat(np.repeat(keep, bm, 0), bk, 1)[:m, :k]
        s = (rng.random((m, k)) < 0.10) & mask
    else:
        s = rng.random((m, k)) < density
    return torch.as_tensor(s.astype(np.float32), device=dev)


def _lif_inputs(rng, m: int, n: int, dev):
    import torch

    cur = np.where(rng.random((m, n)) < 0.4, rng.normal(0, 0.6, (m, n)),
                   0.0).astype(np.float32)
    cur[rng.random((m, n)) < 0.05] = -0.0     # no input, like +0.0
    return (torch.as_tensor(rng.normal(0.5, 0.4, (m, n)).astype(np.float32),
                            device=dev),
            torch.as_tensor(rng.integers(0, 6, (m, n)).astype(np.int32),
                            device=dev),
            torch.as_tensor(cur, device=dev))


def _lif_v_int(v, el, cur, leak):
    """The plain partial-update potential v * leak^(elapsed + 1) + current."""
    return v * leak ** (el + 1).float() + cur


def _time_api_case(m, k, n, kern, plain, lib, bound) -> dict:
    b, by = bound
    return {"shape": [m, k, n] if k else [m, n],
            "ms": _time_graph_ms(kern), "eager_ms": _time_eager_ms(kern),
            "plain_ms": _time_eager_ms(plain),
            "library_ms": None if lib is None else _time_graph_ms(lib),
            "bound_ms": b, "bound_by": by}


# (M, K, N) of the codebook product's plan edges: K = 1 (one stage, no
# split), K = 1000 and 4100 (the split's last block takes a shorter
# slice), K = 999 and N = 37 (rows not 16-byte aligned: element loads)
CODEBOOK_EDGE_SHAPES = ((BATCH, 1, 64), (BATCH, 1000, 10), (BATCH, 4100, 1024),
                        (RAGGED_ROWS, 999, 37))


def _codebook_edge_cases(rng, arch, dev) -> tuple[float, int]:
    """The codebook kernel at the edges of its lookup table and its plan,
    against the f64 product: int8 indexes drawn from [-20, 20] with an
    8-level codebook (negative bytes and 8..20 contribute 0) at the ARCH
    layer shapes with M = 32, and CODEBOOK_EDGE_SHAPES with 16 levels;
    Gaussian x in f32 and bf16, levels at the ARCH scale N(0, 2/sqrt(K))."""
    import torch

    from repro_torch.kernels import codebook_matmul as CBM

    sizes = arch.layer_sizes
    cases = [((BATCH, sizes[i], sizes[i + 1]), 8, (-20, 21))
             for i in range(len(sizes) - 1)]
    cases += [(shape, 16, (0, 16)) for shape in CODEBOOK_EDGE_SHAPES]
    err, n = 0.0, 0
    for (m, k, nn), levels, (lo, hi) in cases:
        idx = torch.as_tensor(rng.integers(lo, hi, (k, nn)).astype(np.int8),
                              device=dev)
        cb = torch.as_tensor(np.sort(rng.normal(0, 2.0 / np.sqrt(k), levels))
                             .astype(np.float32), device=dev)
        x = torch.as_tensor(rng.normal(0, 1, (m, k)).astype(np.float32),
                            device=dev)
        for xt in (x, x.to(torch.bfloat16)):
            got = CBM.codebook_matmul(xt, idx, cb)
            want = _exact_product(xt, CBM.dequantize(idx, cb))
            torch.cuda.synchronize()
            err = max(err, _assert_close(
                f"codebook_matmul [M={m} K={k} N={nn} L={levels} idx in "
                f"[{lo}, {hi})] x {xt.dtype}", got, want))
            n += 1
    return err, n


def api_kernel_phase(arch, qws, seed: int) -> dict:
    """The kernel API's three kernels against their plain versions on the
    card at the ARCH layer shapes and three row counts: M = 32 (one step
    of the kernel-API path), M = RAGGED_ROWS (edge row tiles in both
    products) and M = 640 (a whole run through the leading dims).  Then
    timed at density 0.10 at M = 32, the shape the path runs, which the
    kernels line reports, and at M = 640."""
    import torch

    from repro_torch.core.quant import dequantize
    from repro_torch.kernels import codebook_matmul as CBM
    from repro_torch.kernels import lif_update as LU
    from repro_torch.kernels import zspe_spmm as ZS
    from repro_torch.kernels.ops import _pick_block

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 3)
    rows = BATCH * arch.timesteps
    leak = 0.9
    err = {"zspe_spmm": 0.0, "codebook_matmul": 0.0, "lif_update": 0.0}
    n_cases = dict.fromkeys(err, 0)
    timing = {name: [] for name in err}
    for q in qws:
        idx, cb = q.idx, q.codebook[0]
        w = dequantize(q)
        k, n = w.shape
        for m in (BATCH, RAGGED_ROWS, rows):
            block = _pick_block(m, k, n)
            for density in (*DENSITIES, None):
                s = _api_spikes(rng, m, k, density, dev, block[:2])
                desc = f"[M={m} K={k} N={n} density={density}]"
                for sd in ((s, s.to(torch.int8)) if density == TIME_DENSITY
                           else (s,)):
                    out, skipped = ZS.zspe_spmm(sd, w, block=block)
                    _, want_skipped = ZS.zspe_spmm_plain(sd, w, block)
                    torch.cuda.synchronize()
                    if not torch.equal(skipped, want_skipped):
                        raise AssertionError(f"zspe_spmm {desc}: skip "
                                             f"counters differ")
                    if density is None and int(skipped.sum()) == 0:
                        raise AssertionError(f"zspe_spmm {desc}: no tile "
                                             f"skipped")
                    err["zspe_spmm"] = max(err["zspe_spmm"], _assert_close(
                        f"zspe_spmm {desc} {sd.dtype}", out,
                        _exact_product(sd, w)))
                    n_cases["zspe_spmm"] += 1
                gauss = torch.as_tensor(
                    rng.normal(0, 1, s.shape).astype(np.float32), device=dev)
                xs = ((s, gauss, gauss.to(torch.bfloat16))
                      if density == TIME_DENSITY else (s,))
                for x in xs:
                    got = CBM.codebook_matmul(x, idx, cb)
                    want = _exact_product(x, CBM.dequantize(idx, cb))
                    torch.cuda.synchronize()
                    err["codebook_matmul"] = max(
                        err["codebook_matmul"],
                        _assert_close(f"codebook_matmul {desc} x {x.dtype}",
                                      got, want))
                    n_cases["codebook_matmul"] += 1
            v, el, cur = _lif_inputs(rng, m, n, dev)
            got = LU.lif_update(v, el, cur, threshold=1.0, leak=leak)
            want = LU.lif_update_plain(v, el, cur, threshold=1.0, leak=leak,
                                       reset=0.0)
            torch.cuda.synchronize()
            err["lif_update"] = max(err["lif_update"], check_step(
                f"lif_update [{m}, {n}]", got, want, LIF_INTS,
                _lif_v_int(v, el, cur, leak)))
            n_cases["lif_update"] += 1

        for m in (BATCH, rows):
            s = _api_spikes(rng, m, k, TIME_DENSITY, dev)
            v, el, cur = _lif_inputs(rng, m, n, dev)
            block = _pick_block(m, k, n)
            nz = s != 0
            zspe_bytes = (s.numel() * 4 + int(nz.any(0).sum()) * n * 4
                          + m * n * 4
                          + 4 * -(-m // block[0]) * -(-n // block[2]))
            timing["zspe_spmm"].append(_time_api_case(
                m, k, n, lambda: ZS.zspe_spmm(s, w, block=block),
                lambda: ZS.zspe_spmm_plain(s, w, block),
                lambda: torch.matmul(s, w),
                _roof(zspe_bytes, int(nz.sum()) * n)))
            timing["codebook_matmul"].append(_time_api_case(
                m, k, n, lambda: CBM.codebook_matmul(s, idx, cb),
                lambda: CBM.codebook_matmul_plain(s, idx, cb),
                lambda: torch.matmul(s, cb[idx.long()]),
                _roof(s.numel() * 4 + idx.numel() + cb.numel() * 4
                      + m * n * 4, 2 * m * k * n)))
            timing["lif_update"].append(_time_api_case(
                m, 0, n,
                lambda: LU.lif_update(v, el, cur, threshold=1.0, leak=leak),
                lambda: LU.lif_update_plain(v, el, cur, threshold=1.0,
                                            leak=leak, reset=0.0),
                None, _roof(LIF_BYTES * v.numel(), 0)))
    edge_err, edge_n = _codebook_edge_cases(rng, arch, dev)
    err["codebook_matmul"] = max(err["codebook_matmul"], edge_err)
    n_cases["codebook_matmul"] += edge_n
    results = {}
    for name, shapes in timing.items():
        log(f"kernel {name}: {n_cases[name]} cases agree, max |diff| "
            f"{err[name]:.3g}; per shape {json.dumps(shapes)}")
        path = [r for r in shapes if r["shape"][0] == BATCH]
        by = {"bytes": 0.0, "operations": 0.0}
        for r in path:
            by[r["bound_by"]] += r["bound_ms"]
        lib = [r["library_ms"] for r in path]
        results[name] = {
            "max_abs_err": err[name], "ms": sum(r["ms"] for r in path),
            "plain_ms": sum(r["plain_ms"] for r in path),
            "library_ms": None if None in lib else sum(lib),
            "bound_ms": sum(r["bound_ms"] for r in path),
            "bound_by": max(by, key=by.get)}
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


def _arch_quantized(arch, seed):
    """The ARCH weights of `_arch_weights`, 16-level quantized on the card
    as the main path quantizes them."""
    from repro_torch import CodebookConfig, quantize

    qcfg = CodebookConfig(n_levels=arch.weight_levels,
                          bit_width=arch.weight_bits, zero_level=True)
    return [quantize(w, qcfg, device=DEVICE)
            for w in _arch_weights(arch, seed)]


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


def _device_breakdown(fn, wall_ms: float,
                      sums=(("fused_kernel_ms", "fused_timestep_kernel"),)
                      ) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler), and
    the card's idle share against the unprofiled wall time `wall_ms`;
    `sums` names (key, substring) pairs: the device ms of the kernels whose
    name holds the substring.  Only device events count: a CPU op (an
    `aten::` op, an autograd node) also carries the device time of the
    kernels it launched, so summing it too would count them twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type != DeviceType.CPU:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
    busy = sum(by_kernel.values())
    if busy == 0:
        log("device breakdown: the profiler saw no device time — not "
            "measured")
        return {}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"device_busy_ms": busy}
    for key, part in sums:
        out[key] = sum(ms for name, ms in by_kernel.items() if part in name)
    out.update(idle_share=max(0.0, 1.0 - busy / wall_ms),
               device_kernels=len(by_kernel))
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
# phase 5: the kernel-API path
# ---------------------------------------------------------------------------

def _timed_ms(fn, reps: int = 5) -> float:
    """Host-clock ms of `fn` ending in a synchronize: warmup, median."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out) * 1e3


def api_path(arch, qws, seed: int) -> dict:
    """The paper's network through `kernels.ops`, one call per layer-step:
    (a) zspe_spmm of the dequantized weights, (b) codebook_matmul of the
    indexes, each followed by lif_update, (c) fused_timestep of the
    indexes and a per-column level table, padded to `_pick_block`'s
    (bm, bn)."""
    import torch

    from repro_torch.core.quant import dequantize
    from repro_torch.kernels import codebook_matmul as CBM
    from repro_torch.kernels import fused_timestep as FT
    from repro_torch.kernels import lif_update as LU
    from repro_torch.kernels import ops
    from repro_torch.kernels import zspe_spmm as ZS

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 2)
    trains = torch.as_tensor(
        (rng.random((BATCH, arch.timesteps, arch.layer_sizes[0]))
         < TIME_DENSITY).astype(np.float32), device=dev)
    ws = [dequantize(q) for q in qws]
    blocks = [ops._pick_block(BATCH, *w.shape) for w in ws]
    tables = [q.codebook[0][:, None].expand(-1, w.shape[1])
              for q, w in zip(qws, ws)]
    on_cpu = [(q.idx.cpu(), t.cpu()) for q, t in zip(qws, tables)]
    lif = dict(threshold=arch.threshold, leak=arch.leak, reset=0.0)
    currents = {
        "zspe_spmm": lambda li, s: ops.zspe_spmm(s, ws[li]),
        "codebook_matmul": lambda li, s: ops.codebook_matmul(
            s, qws[li].idx, qws[li].codebook[0])}
    plain_currents = {
        "zspe_spmm": lambda li, s: ZS.zspe_spmm_plain(s, ws[li],
                                                      blocks[li])[0],
        "codebook_matmul": lambda li, s: CBM.codebook_matmul_plain(
            s, qws[li].idx, qws[li].codebook[0])}
    exact_weights = {
        "zspe_spmm": ws,
        "codebook_matmul": [CBM.dequantize(q.idx, q.codebook[0])
                            for q in qws]}

    def fused(li, s, v, el, on=None):
        idx, table = (qws[li].idx, tables[li]) if on is None else on[li]
        return ops.fused_timestep(s, idx, v, el, codebook=table,
                                  block=blocks[li][::2], **lif)

    def api_step(name):
        """One layer-step of loop `name` on the kernels: its outputs and
        the current (None in the fused loop)."""
        def step(li, s, v, el):
            if name == "fused_timestep":
                return fused(li, s, v, el), None
            cur = currents[name](li, s)
            return ops.lif_update(v, el, cur, **lif), cur
        return step

    def plain_step(name):
        def step(li, s, v, el):
            cur = plain_currents[name](li, s)
            return LU.lif_update_plain(v, el, cur, **lif), cur
        return step

    def check(name, li, s, v, el, got, cur) -> float:
        """One layer-step of loop `name` against the plain versions on the
        same inputs: the current (a, b), then the LIF outputs."""
        what = f"kernel-API loop {name}, layer {li + 1}"
        if name == "fused_timestep":
            want = [o.to(dev) for o in fused(li, s.cpu(), v.cpu(), el.cpu(),
                                             on_cpu)]
            return check_step(what, got, want, FUSED_INTS,
                              _lif_v_int(v, el, s @ ws[li], arch.leak),
                              arch.threshold, touched=want[3])
        err = _assert_close(f"{what} current", cur,
                            _exact_product(s, exact_weights[name][li]))
        want = LU.lif_update_plain(v, el, cur, **lif)
        return max(err, check_step(what, got, want, LIF_INTS,
                                   _lif_v_int(v, el, cur, arch.leak),
                                   arch.threshold))

    def run(step, name=None):
        """Spike totals per layer of one B x T run; with `name`, every
        layer-step is also held against the plain versions."""
        states = [(torch.zeros(BATCH, n, device=dev),
                   torch.zeros(BATCH, n, dtype=torch.int32, device=dev))
                  for n in arch.layer_sizes[1:]]
        totals = torch.zeros(len(qws), dtype=torch.float64, device=dev)
        err = 0.0
        for t in range(arch.timesteps):
            s = trains[:, t].contiguous()
            for li in range(len(qws)):
                out, cur = step(li, s, *states[li])
                if name is not None:
                    err = max(err, check(name, li, s, *states[li], out, cur))
                states[li] = (out[0], out[1])
                s = out[2]
                totals[li] += s.sum()
        return totals.cpu().numpy(), err

    mods = (ZS, CBM, LU, FT)
    want = arch.timesteps * len(qws)
    totals, perf = {}, {}
    for name in (*currents, "fused_timestep"):
        for mod in mods:
            mod.reset_launches()
        # each layer-step is held against the plain versions on the same
        # inputs as it runs; the plain versions launch no kernel
        got, err = run(api_step(name), name)
        torch.cuda.synchronize()
        launches = {}
        for mod in mods:
            launches.update(mod.launches)
        expect = dict.fromkeys(launches, 0)
        expect.update({"fused_timestep_codebook": want}
                      if name == "fused_timestep"
                      else {name: want, "lif_update": want})
        if launches != expect:
            raise AssertionError(f"kernel-API loop {name}: launches "
                                 f"{launches}, expected {expect}")
        log(f"kernel-API loop {name}: {launches}; every layer-step agrees "
            f"with the plain versions (max |diff| {err:.3g})")
        if name != "fused_timestep":
            plain, _ = run(plain_step(name))
            rel = np.abs(got - plain) / np.maximum(plain, 1.0)
            log(f"kernel-API loop {name}: spikes per layer {got.tolist()} "
                f"plain {plain.tolist()} (max rel {rel.max():.3g})")
            if rel.max() > SPIKE_REL_TOL:
                raise AssertionError(f"kernel-API loop {name}: spike totals "
                                     f"differ from the plain loop by "
                                     f"{rel.max():.3g} relative")
        totals[name] = got
        perf[name] = {"launches": launches, "max_abs_err": err}
    b = totals["codebook_matmul"]
    for name in ("zspe_spmm", "fused_timestep"):
        rel = np.abs(totals[name] - b) / np.maximum(b, 1.0)
        log(f"kernel-API loop {name}: spikes per layer "
            f"{totals[name].tolist()}, loop codebook_matmul {b.tolist()} "
            f"(max rel {rel.max():.3g})")
        if rel.max() > SPIKE_REL_TOL:
            raise AssertionError(f"kernel-API loops {name} and "
                                 f"codebook_matmul differ by "
                                 f"{rel.max():.3g} relative")
    if b[0] == 0:
        raise AssertionError("kernel-API path: layer 1 never spiked")

    for name in perf:
        step = api_step(name)
        ms = _timed_ms(lambda: run(step))
        perf[name].update(ms_per_loop=ms, **_device_breakdown(
            lambda: run(step), ms,
            tuple((f"{k}_kernel_ms", f"{k}_")
                  for k in ("zspe", "codebook", "lif", "fused_timestep"))))
        log(f"kernel-API loop {name}: {json.dumps(perf[name])}")

    # one codebook_matmul backward at layer 1 against plain autograd
    q = qws[0]
    x0 = torch.as_tensor(rng.normal(0, 1, (BATCH * arch.timesteps,
                                           q.idx.shape[0]))
                         .astype(np.float32), device=dev)
    grads = []
    for fwd in (lambda x, c: ops.codebook_matmul(x, q.idx, c),
                lambda x, c: x @ CBM.dequantize(q.idx, c)):
        x = x0.clone().requires_grad_()
        c = q.codebook[0].clone().requires_grad_()
        (fwd(x, c) ** 2).sum().backward()
        grads.append((x.grad, c.grad))
    torch.cuda.synchronize()
    for got_g, want_g, what in zip(*grads, ("gx", "gcb")):
        torch.testing.assert_close(got_g, want_g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, msg=f"codebook {what}")
        rel = float(((got_g - want_g).abs()
                     / want_g.abs().clamp(min=GRAD_ATOL)).max())
        log(f"codebook_matmul backward at layer 1: {what} agrees with "
            f"plain autograd (max rel {rel:.3g})")
    return perf


# ---------------------------------------------------------------------------
# phase 6: the LM serving path
# ---------------------------------------------------------------------------

LM_ARCH = "granite-3-2b"       # configs/granite_3_2b.py ARCH, full width
LM_SLOTS = 4
LM_REQUESTS = 8
LM_PROMPT = 512
LM_NEW = 16
LM_CACHE = 640
FLASH_F32_TOL = 2e-5           # online vs one-pass softmax: abs + rel
FLASH_BF16_TOL = 2e-2          # p and the output rounded to bf16: abs
H100_BF16_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
# Last-token logits of one bf16 prefill over 512 tokens (flash route)
# against a prefill over 511 plus one decode step (plain SDPA): the two
# round in other places (GEMM shapes, flash vs one-pass softmax, each
# rounded to bf16) through 40 layers.  Logits are O(1) to O(4), where a
# bf16 ulp is 2^-7 to 2^-5; the bound allows a few ulp at the top.
LM_LOGIT_TOL = 0.125


def _flash_case(rng, b, h, kv, s, t, hd, dtype, dev):
    import torch

    return [torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32),
                            device=dev).to(dtype)
            for shape in ((b, h, s, hd), (b, kv, t, hd), (b, kv, t, hd))]


def _flash_diff(got, want) -> float:
    """Max |got - want|; raises beyond the tolerance of the input type."""
    import torch

    d = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        bad = d > FLASH_F32_TOL + FLASH_F32_TOL * want.float().abs()
    else:
        bad = d > FLASH_BF16_TOL
    if bool(bad.any()):
        raise AssertionError(f"flash_attention {tuple(got.shape)} "
                             f"{got.dtype}: off by up to {float(d.max())}")
    return float(d.max())


def _flash_bound(q, k, causal: bool) -> tuple[float, str]:
    """q, k, v read once and o written once, or the score and PV products
    of the pairs the mask keeps at the tensor-core rate of the type."""
    b, h, s, hd = q.shape
    t = k.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    pairs = sum(min(r + 1, t) for r in range(s)) if causal else s * t
    ops = 4 * b * h * pairs * hd
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    rate = H100_BF16_PER_S if q.element_size() == 2 else H100_F32_PER_S
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_kernel_phase(seed: int) -> dict:
    """The flash kernel against its plain version over the cases, then
    timed at the served prefill shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 6)
    cfg_shape = (4, 32, 8, LM_PROMPT, LM_PROMPT, 64)    # B H KV S T hd
    hd128_shape = cfg_shape[:5] + (128,)                # granite-3-8b's
    cases = [(cfg_shape, torch.bfloat16, True),
             (hd128_shape, torch.bfloat16, True)]
    for s in (128, 1024):
        for hd in (16, 32, 64, 128):
            for group in (1, 4):
                for causal in (True, False):
                    for dtype in (torch.float32, torch.bfloat16):
                        cases.append(((2, 8, 8 // group, s, s, hd), dtype,
                                      causal))
    for s, t in ((128, 512), (384, 256)):      # T > S and S > T, causal
        for hd in (32, 64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                cases.append(((2, 8, 2, s, t, hd), dtype, True))
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape, dtype, causal in cases:
        q, k, v = _flash_case(rng, *shape, dtype, dev)
        got = FA.flash_attention(q, k, v, causal=causal)
        want = FA.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err[dtype] = max(err[dtype], _flash_diff(got, want))
    log(f"kernel flash_attention: {len(cases)} cases agree, max |diff| "
        f"f32 {err[torch.float32]:.3g} (tolerance {FLASH_F32_TOL} abs + "
        f"rel), bf16 {err[torch.bfloat16]:.3g} (tolerance "
        f"{FLASH_BF16_TOL} abs)")

    timed = {}
    for shape in (cfg_shape, hd128_shape):
        q, k, v = _flash_case(rng, *shape, torch.bfloat16, dev)
        bound, by = _flash_bound(q, k, True)
        timed[shape] = {
            "max_abs_err": max(err.values()),
            "ms": _time_graph_ms(lambda: FA.flash_attention(q, k, v)),
            "plain_ms": _time_eager_ms(
                lambda: FA.flash_attention_plain(q, k, v)),
            "library_ms": _time_graph_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)),
            "bound_ms": bound, "bound_by": by}
        log(f"kernel flash_attention at (B, H, KV, S, T, hd) = {shape} "
            f"bf16 causal: {json.dumps(timed[shape])}")
    return timed[cfg_shape]


def _serve_once(cfg, model, prompts, instrument=None):
    """One `Server.run` over fresh requests; `instrument` maps "prefill" /
    "decode" to lists that receive each call's host-clock ms (each call
    synchronised on both sides)."""
    import torch

    from repro_torch.serve.server import Request, Server

    srv = Server(cfg, model, device=DEVICE, batch_slots=LM_SLOTS,
                 cache_len=LM_CACHE)
    if instrument is not None:
        def timed(fn, key):
            def call(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                instrument[key].append((time.perf_counter() - t0) * 1e3)
                return out
            return call
        srv.prefill = timed(srv.prefill, "prefill")
        srv.decode = timed(srv.decode, "decode")
    for uid, p in enumerate(prompts):
        srv.submit(Request(uid=uid, prompt=p, max_new_tokens=LM_NEW))
    return srv.run()


def serving_path(seed: int) -> dict:
    """granite-3-2b at full width, bf16, random weights from the port's
    init: 8 requests of 512 prompt tokens through a 4-slot `Server`, 16
    new tokens each; then prefill + decode held against a prefill over
    one more token, and every layer's flash call against the plain
    version on the same q / k / v."""
    import torch

    from repro_torch.configs import registry as R
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as ATT
    from repro_torch.models import transformer as T

    dev = torch.device(DEVICE)
    cfg = R.get_arch(LM_ARCH)
    t0 = time.perf_counter()
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    norms = 2 * cfg.d_model * cfg.n_layers    # not in the analytic count
    if n_params != cfg.param_count() + norms:
        raise AssertionError(f"{n_params} parameters, ArchConfig says "
                             f"{cfg.param_count()} + {norms} norm weights")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, LM_PROMPT).astype(np.int32)
               for _ in range(LM_REQUESTS)]
    _serve_once(cfg, model, prompts[:LM_SLOTS])          # warm up
    torch.cuda.synchronize()

    # (b) the served run: the counts from 0 just before, read just after.
    # Each prefill / decode call is timed between two synchronisations;
    # the server crosses to the host after each call anyway, so the run's
    # wall time is the same as without them.
    torch.cuda.reset_peak_memory_stats()
    phase = {"prefill": [], "decode": []}
    FA.reset_launches()
    t0 = time.perf_counter()
    done = _serve_once(cfg, model, prompts, phase)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(FA.launches)
    want = -(-LM_REQUESTS // LM_SLOTS) * cfg.n_layers
    if launches != {"flash_attention": want, "flash_attention_wgmma": want}:
        raise AssertionError(f"served run launches {launches}, expected "
                             f"{want} flash launches, all on the "
                             f"tensor-core kernel")
    toks = [r.out_tokens for r in done]
    if len(done) != LM_REQUESTS or any(
            len(t) != LM_NEW or min(t) < 0 or max(t) >= cfg.vocab
            for t in toks):
        raise AssertionError(f"bad served tokens {toks}")
    n_tok = sum(len(t) for t in toks)
    perf = {"tokens_per_s": n_tok / wall, "ms_per_run": wall * 1e3,
            "tokens": n_tok, "launches": launches,
            "prefill_ms_per_batch": statistics.median(phase["prefill"]),
            "decode_ms_per_step": statistics.median(phase["decode"]),
            "prefill_batches": len(phase["prefill"]),
            "decode_steps": len(phase["decode"]),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "init_s": init_s, "n_params": n_params}
    log(f"served run: {LM_REQUESTS} requests x {LM_PROMPT} prompt tokens, "
        f"{LM_NEW} new each, {LM_SLOTS} slots: {json.dumps(perf)}; first "
        f"tokens {[t[:4] for t in toks[:2]]}")
    # the device breakdown of one batch (a prefill and its decode steps),
    # against the same batch unprofiled: the profiler's own host cost
    # grows with the ~5,000 ops of every decode step
    batch = prompts[:LM_SLOTS]
    t0 = time.perf_counter()
    _serve_once(cfg, model, batch)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    perf.update(batch_ms=batch_ms, **_device_breakdown(
        lambda: _serve_once(cfg, model, batch), batch_ms,
        (("flash_kernel_ms", "flash_attention"),)))

    # (c) the path held together at full width
    tokens = torch.as_tensor(np.stack(prompts[:LM_SLOTS]), device=dev)
    flash = ATT.flash_attention
    layer_err = []

    def checked(q, k, v, *, causal=True):
        out = flash(q, k, v, causal=causal)
        layer_err.append(_flash_diff(
            out, FA.flash_attention_plain(q, k, v, causal)))
        return out

    ATT.flash_attention = checked
    try:
        full, _ = T.forward_prefill(model, cfg, {"tokens": tokens}, LM_CACHE)
    finally:
        ATT.flash_attention = flash
    if len(layer_err) != cfg.n_layers:
        raise AssertionError(f"{len(layer_err)} flash calls in one prefill")
    log(f"every layer's flash call agrees with the plain version on its "
        f"q / k / v (max |diff| {max(layer_err):.3g})")
    FA.reset_launches()
    _, st = T.forward_prefill(model, cfg,
                              {"tokens": tokens[:, :LM_PROMPT - 1]}, LM_CACHE)
    got, st = T.forward_decode(model, cfg, st, tokens[:, LM_PROMPT - 1:])
    torch.cuda.synchronize()
    if FA.launches["flash_attention"] != 0:
        raise AssertionError("prefill over 511 tokens took the flash route")
    full, got = full.float(), got.float()
    if not (bool(full.isfinite().all()) and full.shape == (LM_SLOTS,
                                                           cfg.vocab)):
        raise AssertionError(f"bad logits {tuple(full.shape)}")
    diff = float((full - got).abs().max())
    top2 = full.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    flipped = full.argmax(-1) != got.argmax(-1)
    log(f"prefill(512) vs prefill(511) + decode: max |logit diff| {diff:.4g} "
        f"(tolerance {LM_LOGIT_TOL}, logits up to "
        f"{float(full.abs().max()):.3g}); greedy tokens differ in "
        f"{int(flipped.sum())} of {LM_SLOTS} rows; top-2 gaps "
        f"{[round(float(g), 4) for g in gap]}")
    if diff > LM_LOGIT_TOL:
        raise AssertionError(f"prefill and decode logits differ by {diff}")
    if bool((flipped & (gap >= LM_LOGIT_TOL)).any()):
        raise AssertionError("a greedy token differs away from a near-tie")
    perf.update(layer_max_abs_err=max(layer_err), decode_logit_diff=diff)
    return perf


def _sass_counts(build) -> dict:
    """Tensor-core (HGMMA) and TMA (UTMALDG) instructions in the built
    flash library, by `cuobjdump -sass`; raises if either is missing."""
    lib = build._target("flash_attention")
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {op: sum(op in line for line in sass.splitlines())
              for op in ("HGMMA", "UTMALDG")}
    if not all(counts.values()):
        raise AssertionError(f"flash_attention SASS lacks wgmma or TMA: "
                             f"{counts}")
    return counts


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
    log(f"flash_attention SASS: {json.dumps(_sass_counts(build))}")

    # 3. kernels
    t0 = time.perf_counter()
    kern = kernel_phase(ARCH, args.seed)
    qws = _arch_quantized(ARCH, args.seed)
    kern.update(api_kernel_phase(ARCH, qws, args.seed))
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    # 4. main path
    mp = main_path(ARCH, args.seed)

    # 5. kernel-API path
    api = api_path(ARCH, qws, args.seed)

    # 6. LM serving path
    t0 = time.perf_counter()
    kern["flash_attention"] = flash_kernel_phase(args.seed)
    t1 = time.perf_counter()
    lm = serving_path(args.seed)
    log(f"LM serving phase: {time.perf_counter() - t0:.1f} s (kernel "
        f"checks {t1 - t0:.1f} s)")

    # kernels line, then the result; launches from phase 4 (fused), phase
    # 5 (kernel API, all three loops) and phase 6 (the served run)
    launches = dict(mp["launches"])
    for loop in api.values():
        for kname, count in loop["launches"].items():
            launches[kname] = launches.get(kname, 0) + count
    launches["flash_attention"] = lm["launches"]["flash_attention"]
    csrc = "src/repro_torch/kernels/csrc"
    kernels = {
        "fused_timestep_codebook": ("fused_timestep.cu",
                                    "fused_timestep.py:231"),
        "fused_timestep_dense": ("fused_timestep.cu", "fused_timestep.py:266"),
        "lif_update": ("lif_update.cu", "lif_update.py:47"),
        "zspe_spmm": ("zspe_spmm.cu", "zspe_spmm.py:61"),
        "codebook_matmul": ("codebook_matmul.cu", "codebook_matmul.py:62"),
        "flash_attention": ("flash_attention.cu", "flash_attention.py:69")}
    line = {"kernels": [
        {"name": kname, "route": "cuda", "source": f"{csrc}/{src}",
         "replaces": f"src/repro/kernels/{rep}",
         "launches": launches[kname], **kern[kname]}
        for kname, (src, rep) in kernels.items()]}
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
