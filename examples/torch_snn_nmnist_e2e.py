"""End-to-end paper reproduction on the PyTorch port: train an SNN on
NMNIST-like event data with surrogate gradients, quantize to the chip's
shared codebooks, compile it (partition -> place -> route) onto the
20-core fullerene SoC and report accuracy + pJ/SOP + power against the
paper's Table I.  Port of examples/snn_nmnist_e2e.py.

Inference runs on the batched compiled engine (a loop over time, the
batch in one pass); one sample is cross-checked against the interpretive
reference simulator as a live differential test.  Runs on the card
unless --device cpu.

Run:  PYTHONPATH=src python examples/torch_snn_nmnist_e2e.py [--steps 60]
      [--timesteps 10] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import compiler as COMP
from repro_torch.core.quant import CodebookConfig, dequantize, quantize
from repro_torch.core.soc import ChipSimulator
from repro_torch.data.synthetic import EventStream
from repro_torch.device import resolve_device
from repro_torch.models import snn as SNN
from repro_torch.train.snn_trainer import SNNTrainConfig, SNNTrainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--timesteps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ev = EventStream(timesteps=args.timesteps, height=16, width=16, seed=0)
    cfg = SNN.SNNConfig(layer_sizes=(ev.n_inputs, 256, 10),
                        timesteps=args.timesteps)

    print(f"== train: {cfg.layer_sizes} LIF MLP, surrogate-gradient BPTT ==")
    trainer = SNNTrainer(cfg, SNNTrainConfig(steps=args.steps, batch=64,
                                             lr=4e-3, log_every=0),
                         device=dev)
    params, _ = trainer.fit(
        lambda step: ev.batch(64, step, device=dev),
        on_metrics=lambda s, m: (print(
            f"step {s:3d} loss {m['loss']:.3f} "
            f"spike-density {m['density']:.3f}")
            if s % 10 == 0 else None))

    sp, lb = ev.batch(256, 99_999, device=dev)
    acc_fp = float(SNN.accuracy(params, cfg, sp, lb))

    print("\n== quantize to per-core N=16 x W=8-bit shared codebooks (C3) ==")
    qparams = [quantize(w, cfg.quant) for w in params]
    weights = [dequantize(q) for q in qparams]
    acc_q = float(SNN.accuracy(weights, cfg, sp, lb))
    print(f"accuracy fp32 {acc_fp:.3f} -> quantized {acc_q:.3f} "
          f"(paper NMNIST: 0.988)")

    print("\n== compile onto the 20-core fullerene SoC (partition -> "
          "place -> route) ==")
    test_sp, _ = ev.batch(8, 123, device=dev)
    # profile-guided traffic: measure per-layer spike rates on real events
    rates = COMP.measure_spike_rates(weights, test_sp[1])
    graph = COMP.from_weights(weights, spike_rates=rates)
    compiled = COMP.compile_network(graph, verify=True)
    print(f"compiled: {compiled.summary()}")
    print(f"hop-weighted traffic cost {compiled.cost:.1f} vs greedy "
          f"baseline {compiled.baseline_cost:.1f} "
          f"({(compiled.improvement - 1) * 100:+.1f}%)")

    sim = ChipSimulator(weights, quant_cfg=CodebookConfig(16, 8),
                        freq_hz=100e6, mapping=compiled.to_soc_mapping(),
                        engine="compiled", device=dev)
    print(f"core assignment: {[(a.core_id, a.layer, a.n_neurons) for a in sim.mapping.assignments]}")

    # the whole 8-sample batch in one pass of the engine
    counts, reports = sim.run_batch(test_sp)          # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    counts, reports = sim.run_batch(test_sp)
    counts = counts.cpu()                              # synchronises
    dt = time.time() - t0
    rep = reports[0]
    print(f"sparsity {rep.stats.sparsity:.3f}  "
          f"pJ/SOP {rep.pj_per_sop:.3f} (paper: 0.96 @ NMNIST)  "
          f"power {rep.power_mw:.2f} mW (paper: 2.8 mW min)  "
          f"NoC energy {rep.noc_energy_pj:.0f} pJ over "
          f"{rep.stats.noc_hops:.0f} hops")
    print(f"throughput {rep.gsops:.3f} GSOP/s nominal; batched engine "
          f"served {test_sp.shape[0]} samples in {dt * 1e3:.1f} ms "
          f"({test_sp.shape[0] / max(dt, 1e-9):.0f} samples/s)")

    # live differential check: the interpretive reference must agree
    ref = ChipSimulator(weights, quant_cfg=CodebookConfig(16, 8),
                        freq_hz=100e6, mapping=sim.mapping,
                        engine="reference", device=dev)
    counts_ref, rep_ref = ref.run(test_sp[0])
    assert np.array_equal(counts[0].numpy(), counts_ref.cpu().numpy())
    assert abs(rep.energy_pj - rep_ref.energy_pj) < 1e-6 * rep_ref.energy_pj
    print("differential check vs interpretive reference: spikes identical, "
          "energy within 1e-6")
    return {"acc_fp": acc_fp, "acc_q": acc_q, "counts": counts,
            "report": rep, "ref_counts": counts_ref.cpu(),
            "ref_report": rep_ref, "compiled": compiled, "seconds": dt}


if __name__ == "__main__":
    main()
