#!/usr/bin/env python
"""Time the k-means cluster sums of `repro_torch.core.quant` three ways,
inside a QAT training step and inside one whole-tensor fit:

    sum        `where(...).sum(dim=0)`: the device picks the adds' order
    tree_copy  the pairwise tree, a new half-size tensor at every level
    tree       the pairwise tree reduced in place (`quant._tree_colsum`)

The step is `chip_smoke.py` phase 10's: `SNNTrainer.step` of the paper's
network (2312-4096-1024-10, T 20, QAT, B 32, its hardware-aware loss);
the fit is `quant.quantize` of a 2312 x 4096 tensor (16 levels, 8 bits).
The variants run in the order sum, tree_copy, tree, tree, tree_copy,
sum, `--rounds` times over; each time is the median (with the least and
the most) over all of a variant's samples; on the card, each round also
takes one step's device busy time (torch.profiler: the kernels' own
time) and the allocator's peak over one step.  The two trees must give
bitwise the same fit.  Prints one JSON object with the card's name and
power limit.

    PYTHONPATH=src python scripts/torch_colsum_bench.py [--reps 5] \
        [--rounds 2]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def tree_copy(m):
    """The pairwise tree of `quant._tree_colsum`, out of place."""
    while m.shape[0] > 1:
        h = m.shape[0] // 2
        top = m[:h] + m[h:2 * h]
        if m.shape[0] % 2:
            top[h - 1] += m[2 * h]
        m = top
    return m[0]


def _ms(fn, reps: int, sync) -> list[float]:
    fn()
    sync()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _device_busy_ms(fn, sync) -> float:
    """The kernels' own device time over one call of `fn`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card")
    ap.add_argument("--widths", default="2312,4096,1024,10")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--timesteps", type=int, default=20)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.core import quant as Q
    from repro_torch.data.synthetic import EventStream
    from repro_torch.device import resolve_device
    from repro_torch.models import snn as SNN
    from repro_torch.train.snn_trainer import (HWLossConfig, SNNTrainConfig,
                                               SNNTrainer)

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    widths = tuple(int(x) for x in args.widths.split(","))
    side = int(round((widths[0] / 2) ** 0.5))
    ev = EventStream(height=side, width=side, timesteps=args.timesteps,
                     seed=args.seed)
    cfg = SNN.SNNConfig(layer_sizes=widths, timesteps=args.timesteps,
                        qat=True)
    hw = HWLossConfig(rate_weight=1.0, target_rate=0.08, l1_weight=1e-3)
    tr = SNNTrainer(cfg, SNNTrainConfig(steps=1, batch=args.batch, hw=hw),
                    device=dev)
    params, opt = tr.init(torch.Generator().manual_seed(args.seed))
    st, lt = ev.batch(args.batch, 0, device=dev)
    rng = np.random.default_rng(args.seed)
    w = torch.as_tensor(rng.normal(0, 0.05, (widths[0], widths[1]))
                        .astype(np.float32), device=dev)
    qcfg = Q.CodebookConfig(16, 8)

    variants = {"sum": lambda m: m.sum(dim=0), "tree_copy": tree_copy,
                "tree": Q._tree_colsum}
    real = Q._tree_colsum
    step_ms = {k: [] for k in variants}
    fit_ms = {k: [] for k in variants}
    peak_gb = {k: [] for k in variants}
    busy_ms = {k: [] for k in variants}
    fits = {}
    try:
        for name in ("sum", "tree_copy", "tree", "tree", "tree_copy",
                     "sum") * args.rounds:
            Q._tree_colsum = variants[name]
            step_ms[name] += _ms(lambda: tr.step(params, opt, st, lt),
                                 args.reps, sync)
            fit_ms[name] += _ms(lambda: Q.quantize(w, qcfg), args.reps, sync)
            fits[name] = Q.quantize(w, qcfg)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
                tr.step(params, opt, st, lt)
                sync()
                peak_gb[name].append(torch.cuda.max_memory_allocated() / 1e9)
                busy_ms[name].append(_device_busy_ms(
                    lambda: tr.step(params, opt, st, lt), sync))
    finally:
        Q._tree_colsum = real
    a, b = fits["tree"], fits["tree_copy"]
    if not all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])):
        raise AssertionError("the two trees give different fits")
    smi = "not measured"
    if cuda:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    out = {"card": smi, "device": str(dev), "widths": list(widths),
           "batch": args.batch, "timesteps": args.timesteps,
           "reps": args.reps, "rounds": args.rounds,
           "step_ms": {k: [statistics.median(v), min(v), max(v)]
                       for k, v in step_ms.items()},
           "fit_ms": {k: [statistics.median(v), min(v), max(v)]
                      for k, v in fit_ms.items()},
           "step_device_busy_ms": {k: statistics.median(v) if v else None
                                   for k, v in busy_ms.items()},
           "peak_gb": {k: max(v) if v else None
                       for k, v in peak_gb.items()},
           "sum_fit_equals_tree": all(
               torch.equal(x, y) for x, y in zip(fits["sum"][:3], a[:3]))}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
