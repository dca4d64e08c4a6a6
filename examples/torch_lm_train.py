"""Train a small LM end-to-end on the PyTorch port: the train step,
AdamW, the synthetic token stream, async checkpointing and crash-resume.
Port of examples/lm_train.py.  The default config is CPU-sized; --big
selects a ~100M-param model.  Runs on the card unless --device cpu.

Run:  PYTHONPATH=src python examples/torch_lm_train.py --steps 200
      PYTHONPATH=src python examples/torch_lm_train.py --steps 20 \\
          --device cpu
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.train.trainer import Trainer, TrainJobConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--big", action="store_true",
                    help="~100M params (use on the card)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)

    if args.big:
        cfg = ArchConfig("lm-100m", "dense", n_layers=12, d_model=768,
                         n_heads=12, n_kv_heads=12, d_ff=3072, vocab=32768,
                         dtype=torch.bfloat16)
        job = TrainJobConfig(batch=32, seq_len=1024, num_steps=args.steps,
                             save_every=50, ckpt_dir=args.ckpt, lr=3e-4)
    else:
        cfg = ArchConfig("lm-tiny", "dense", n_layers=4, d_model=128,
                         n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
                         dtype=torch.float32)
        job = TrainJobConfig(batch=8, seq_len=64, num_steps=args.steps,
                             save_every=50, ckpt_dir=args.ckpt, lr=1e-3)

    n_params = cfg.param_count()
    print(f"training {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{job.num_steps} steps, ckpt every {job.save_every} -> "
          f"{job.ckpt_dir}")

    tr = Trainer(cfg, job, device=args.device)
    t0 = time.time()
    hist = []

    def on_metrics(step, m, dt):
        hist.append(float(m["loss"]))
        if step % 20 == 0:
            print(f"step {step:4d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"lr {float(m['lr']):.2e} ({dt*1e3:.0f} ms/step)")

    tr.run(on_metrics=on_metrics)
    dt = time.time() - t0
    if hist:
        print(f"\nloss {hist[0]:.3f} -> {hist[-1]:.3f} over {len(hist)} "
              f"steps ({dt:.0f}s, {dt/max(len(hist),1)*1e3:.0f} ms/step)")
        assert hist[-1] < hist[0], "loss must decrease"
    else:
        print("nothing to do (already trained to num_steps; resume works!)")
    return hist


if __name__ == "__main__":
    main()
