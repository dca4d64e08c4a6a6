"""Training launcher: the LM trainer on one device or on a device mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 1000 --batch 32 --seq 1024 --ckpt ckpts/granite2b
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --smoke --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --smoke --device cpu --steps 3 --model-parallel 2
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch granite-3-2b --smoke --device cpu --model-parallel 2

Port of `repro.launch.train` with the same options, plus `--device` (the
card unless "cpu" is asked for).  `--smoke` trains the reduced config in
f32.  `--model-parallel N` trains on the ("data", "model") mesh of
`launch/mesh.py` `make_host_mesh(model=N)` over the launched ranks: the
ranks `torchrun` started (its WORLD_SIZE / RANK / MASTER_* variables),
or else N ranks this launcher spawns (a mesh of 1 x N).  Ranks on one
card (or on the CPU) join over gloo, since NCCL refuses two ranks on one
card; NCCL when every rank has a card of its own.  Checkpoints have the
reference's layout (`train/trainer.py`); rank 0 writes them and prints.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def _parse(argv):
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
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    if args.model_parallel > 1 and "WORLD_SIZE" not in os.environ:
        from repro_torch.launch.mesh import spawn_ranks

        return spawn_ranks(main, argv, args.model_parallel)

    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry as R
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import Trainer, TrainJobConfig

    dev = resolve_device(args.device)
    mesh = None
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        own_cards = dev.type == "cuda" and torch.cuda.device_count() >= world
        dist.init_process_group("nccl" if own_cards else "gloo",
                                init_method="env://")
        mesh = make_host_mesh(model=args.model_parallel, device=dev)
    cfg = R.get_arch(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    job = TrainJobConfig(batch=args.batch, seq_len=args.seq,
                         num_steps=args.steps, save_every=args.save_every,
                         ckpt_dir=args.ckpt, lr=args.lr)
    tr = Trainer(cfg, job, mesh=mesh, device=dev)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    shape = None if mesh is None else dict(zip(mesh.mesh_dim_names,
                                               mesh.shape))
    if lead:
        print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
              f"device={tr.device} mesh={shape} steps={args.steps}",
              flush=True)

    def on_metrics(step, m, dt):
        if lead and step % 10 == 0:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} ({dt*1e3:.0f} ms)",
                  flush=True)

    try:
        state = tr.run(on_metrics=on_metrics)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if lead:
        print("done; checkpoints in", args.ckpt, flush=True)
    return state


if __name__ == "__main__":
    main()
