"""Train→deploy walkthrough on the PyTorch port: hardware-aware training
to chip execution in one pipeline call (repro_torch.deploy).

Trains an NMNIST-like LIF MLP with the three hardware-aware losses
(spike-rate regularization for ZSPE zero-skip, L1 pruning for the
partial-update set, codebook QAT), fits per-core N×W codebooks, compiles
the network onto the fullerene SoC and executes the eval set on the
batched chip engine (the fused-timestep kernel on the card) — then
checks the accuracy/energy parity gates and writes the DeployReport JSON.

Run:  PYTHONPATH=src python examples/torch_train_deploy_nmnist.py
      [--steps 120] [--tiny] [--no-reg] [--out deploy_report.json]
      [--device cpu]

It runs on the card unless `--device cpu` is given.  `--tiny` shrinks
the net/sensor for smoke runs; the exit code is 0 only when both parity
gates pass.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.data.synthetic import EventStream  # noqa: E402
from repro_torch.deploy import DeployConfig, ParityGates, deploy  # noqa: E402
from repro_torch.models.snn import SNNConfig  # noqa: E402
from repro_torch.train.snn_trainer import (HWLossConfig,  # noqa: E402
                                           SNNTrainConfig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--tiny", action="store_true",
                    help="12x12 sensor, one hidden layer, T=6 (smoke)")
    ap.add_argument("--no-reg", action="store_true",
                    help="disable the hardware-aware regularizers")
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--eval-batch", type=int, default=256)
    ap.add_argument("--out", default="deploy_report.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.tiny:
        ev = EventStream(timesteps=6, height=12, width=12, seed=1)
        layers = (ev.n_inputs, 128, 10)
        eval_batch = min(args.eval_batch, 128)
        # an undertrained smoke net sits near its decision boundaries, so
        # quantization flips more eval samples than a converged run does
        gates = ParityGates(accuracy_tol=0.04)
    else:
        ev = EventStream(timesteps=10, height=16, width=16, seed=1)
        layers = (ev.n_inputs, 256, 256, 10)
        eval_batch = args.eval_batch
        gates = ParityGates(accuracy_tol=0.01)

    hw = (HWLossConfig() if args.no_reg else
          HWLossConfig(rate_weight=2.0, target_rate=0.05, l1_weight=1e-3))
    cfg = SNNConfig(layer_sizes=layers, timesteps=ev.timesteps, qat=True)
    dcfg = DeployConfig(
        train=SNNTrainConfig(steps=args.steps, lr=args.lr, hw=hw),
        gates=gates, eval_batch=eval_batch, verbose=True)

    report = deploy(cfg, ev, dcfg, device=args.device)
    print()
    print(report.summary())
    report.save(args.out)
    print(f"\nDeployReport -> {args.out}")
    if not report.passed:
        print("parity gates FAILED", file=sys.stderr)
        print(json.dumps(report.gates, indent=1), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
