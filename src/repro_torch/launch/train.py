"""Training launcher: the LM trainer on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 1000 --batch 32 --seq 1024 --ckpt ckpts/granite2b
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --smoke --device cpu --steps 3

Port of `repro.launch.train` with the same options, plus `--device` (the
card unless "cpu" is asked for).  `--smoke` trains the reduced config in
f32.  The reference's `--model-parallel` builds a mesh; on the port it
must stay 1 until the mesh is ported (ROADMAP Queue 1 #21).  Checkpoints
have the reference's layout (`train/trainer.py`).
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: the mesh and its "
            f"sharding rules are not ported yet (ROADMAP Queue 1 #21); the "
            f"port trains on one device")

    import dataclasses

    import torch

    from repro_torch.configs import registry as R
    from repro_torch.train.trainer import Trainer, TrainJobConfig

    cfg = R.get_arch(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    job = TrainJobConfig(batch=args.batch, seq_len=args.seq,
                         num_steps=args.steps, save_every=args.save_every,
                         ckpt_dir=args.ckpt, lr=args.lr)
    tr = Trainer(cfg, job, device=args.device)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"device={tr.device} steps={args.steps}")

    def on_metrics(step, m, dt):
        if step % 10 == 0:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} ({dt*1e3:.0f} ms)",
                  flush=True)

    state = tr.run(on_metrics=on_metrics)
    print("done; checkpoints in", args.ckpt)
    return state


if __name__ == "__main__":
    main()
