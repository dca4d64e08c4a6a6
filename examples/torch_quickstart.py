"""Quickstart on the PyTorch port: the paper's four contributions in ~70
lines.  Port of examples/quickstart.py: the C3 codebook fit, the C1
zero-skip spike product (`kernels.ops.zspe_spmm`) and the C2 partial LIF
update (`kernels.ops.lif_update`), each one launch of its CUDA kernel on
the card (their plain versions on the CPU), then the C4 fullerene NoC and
the calibrated energy model.  Runs on the card unless --device cpu.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import energy as E
from repro_torch.core import noc as NOC
from repro_torch.core.quant import CodebookConfig, dequantize, quantize
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # ---- C3: non-uniform codebook quantization ---------------------------
    w = torch.tensor(rng.normal(0, 0.02, (512, 256)), dtype=torch.float32,
                     device=dev)
    q = quantize(w, CodebookConfig(n_levels=16, bit_width=8))
    rel = float(torch.sqrt(torch.mean((dequantize(q) - w) ** 2)) / w.std())
    print(f"[C3] 16-level codebook: idx {q.idx.dtype}, table "
          f"{tuple(q.codebook.shape)}, rel-err {rel:.3f}")

    # ---- C1: zero-skip sparse spike matmul (the zspe kernel) -------------
    spikes = torch.tensor(rng.random((128, 512)) < 0.05, dtype=torch.float32,
                          device=dev)
    weights = dequantize(q)
    out, skipped = ops.zspe_spmm(spikes, weights, with_stats=True)
    print(f"[C1] zspe_spmm out {tuple(out.shape)}, skipped MXU tiles: "
          f"{int(skipped.sum())}")

    # ---- C2: partial-membrane-potential LIF update (the LIF kernel) ------
    v = torch.zeros((128, 256), device=dev)
    elapsed = torch.zeros((128, 256), dtype=torch.int32, device=dev)
    v2, el2, fired, touched = ops.lif_update(v, elapsed, out)
    print(f"[C2] LIF: {int(fired.sum())} spikes, {int(touched.sum())}/"
          f"{touched.numel()} neurons touched (partial update)")

    # ---- C4: fullerene-like NoC ------------------------------------------
    m = NOC.fullerene_metrics()
    print(f"[C4] fullerene NoC: degree {m.avg_degree} (var "
          f"{m.degree_variance:.4f}), core-core hops {m.avg_core_hops:.3f}  "
          f"<- paper: 3.75 / 0.93 / 3.16")
    rep = NOC.simulate_traffic(NOC.fullerene_adjacency(),
                               [(12, [20, 25, 30], 64), (15, [31], 64)])
    print(f"[C4] routed {rep.spikes_delivered} spikes, "
          f"{rep.pj_per_spike_hop * 1e3:.1f} fJ/hop, modes {rep.mode_counts}")

    # ---- calibrated energy model -----------------------------------------
    core = E.calibrate_core()
    chip = E.calibrate_chip(core)
    print(f"[E]  core best: {core.gsops(1.0):.3f} GSOP/s @ "
          f"{core.pj_per_sop(1.0):.3f} pJ/SOP; chip @90% sparsity: "
          f"{chip.chip_pj_per_sop(0.9):.2f} pJ/SOP (paper: 0.96); zero-skip "
          f"improvement {core.improvement_vs_baseline():.2f}x")
    return {"quantized": q, "spikes": spikes, "weights": weights,
            "quant_rel_err": rel, "zspe_out": out, "skipped": skipped,
            "lif": (v2, el2, fired, touched), "noc": m, "traffic": rep,
            "chip_pj_per_sop_90": chip.chip_pj_per_sop(0.9)}


if __name__ == "__main__":
    main()
