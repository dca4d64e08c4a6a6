#!/usr/bin/env python
"""Run a traced chip inference on the PyTorch port and print the
energy/cycle attribution report — the chip's flamegraph — optionally
exporting the Perfetto timeline.

    PYTHONPATH=src python scripts/torch_profile_report.py --net tiny
    PYTHONPATH=src python scripts/torch_profile_report.py --net nmnist \
        --engine fused --perfetto chip_trace.json --out profile_report.txt
    PYTHONPATH=src python scripts/torch_profile_report.py --net tiny \
        --device cpu --json profile.json

It runs on the card unless `--device cpu` is given, and takes the flags
of `scripts/profile_report.py` (the JAX package's), whose networks,
weights and trains it builds from the same seeds.  Open the Perfetto
JSON at https://ui.perfetto.dev (or chrome://tracing): cores are threads
inside their domain's process, the NoC track shows the M/M/1
contention-wait spans, and the RISC-V track replays the ENU host
program.  See DESIGN.md §8.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

NETS = {
    "tiny": (64, 48, 10),
    "nmnist": (2312, 512, 10),
}


def build_sim(net: str, engine: str, seed: int, device=None):
    import numpy as np

    from repro_torch.core.quant import CodebookConfig
    from repro_torch.core.soc import ChipSimulator
    from repro_torch.telemetry import TraceConfig

    if net == "probe":
        from repro_torch.core.probes import source_exact_probe

        sim, _, _ = source_exact_probe(engine=engine, device=device,
                                       trace=TraceConfig(enabled=True))
        return sim
    sizes = NETS[net]
    rng = np.random.default_rng(seed)
    weights = [rng.normal(0, 0.4, (sizes[i], sizes[i + 1])).astype(np.float32)
               for i in range(len(sizes) - 1)]
    return ChipSimulator(weights, engine=engine,
                         quant_cfg=CodebookConfig(n_levels=16, bit_width=8),
                         trace=TraceConfig(enabled=True), device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", choices=(*NETS, "probe"), default="tiny")
    ap.add_argument("--engine", default="compiled",
                    choices=("compiled", "fused", "reference"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--timesteps", type=int, default=12)
    ap.add_argument("--density", type=float, default=0.1,
                    help="input spike density of the synthetic train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--perfetto", default=None,
                    help="write the Chrome-trace/Perfetto JSON here")
    ap.add_argument("--out", default=None,
                    help="write the text report here (also printed)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the raw profile tables as JSON here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.telemetry import export_perfetto, format_profile, profile

    sim = build_sim(args.net, args.engine, args.seed, args.device)
    n_in = int(sim.weights[0].shape[0])
    rng = np.random.default_rng(args.seed + 1)
    trains = torch.as_tensor(
        (rng.random((args.batch, args.timesteps, n_in)) < args.density
         ).astype(np.float32), device=sim.device)
    sim.run_batch(trains)
    trace = sim.last_trace()
    prof = profile(trace, core_model=sim.core_model, riscv=sim.riscv)
    report = format_profile(prof, top_k=args.top_k)
    print(report)

    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
        print(f"# report -> {args.out}", file=sys.stderr)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(prof, f, indent=1)
        print(f"# profile JSON -> {args.json_out}", file=sys.stderr)
    if args.perfetto:
        export_perfetto(trace, args.perfetto)
        print(f"# perfetto timeline -> {args.perfetto} "
              f"(open at https://ui.perfetto.dev)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
