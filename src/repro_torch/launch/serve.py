"""Serving launcher: batched prefill + greedy decode on one card or on a
device mesh.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --prompt-len 512 --cache-len 640
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-1b-a400m --quant --prompt-len 512 --cache-len 640
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch mamba2-130m | zamba2-2.7b | whisper-tiny [--quant] \\
        --prompt-len 512 --cache-len 640
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi-3-vision-4.2b [--quant] --prompt-len 64 --cache-len 768
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --prompt-len 512 --cache-len 640 --model-parallel 2
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch granite-3-2b --smoke --device cpu --model-parallel 2

The dense (granite, yi, mistral), moe (granite-moe, moonshot), ssm
(mamba2-130m), hybrid (zamba2-2.7b), audio (whisper-tiny: the server
feeds the encoder zero frames, the reference's stub frontend) and vlm
(phi-3-vision-4.2b: zero patch embeddings, which take 576 cache
positions before the prompt) archs.
Port of `repro.launch.serve` with the same options, plus `--device`
(the card unless "cpu" is asked for) and `--seed` (random weights from
the port's init; prompts from numpy).  `--quant` fits the C3 codebooks
of the blocks on the device (`quant.lm_quant.quantize_blocks`), prints
the reference's weight-bytes line and serves with `quant_serving`.
`--model-parallel N` serves on the ("data", "model") mesh of
`launch/mesh.py` `make_host_mesh(model=N)`, as the reference's server
runs on its mesh, over the launched ranks: the ones `torchrun` started,
or else N ranks this launcher spawns (a mesh of 1 x N; gloo when they
share a card or the CPU, NCCL when each has its own card, as
`launch/train.py` joins them).  Every rank builds the same weights from
`--seed` and serves the same requests; rank 0 prints.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> list | None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--quant", action="store_true",
                    help="serve with C3 codebook-quantized weights")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    args = ap.parse_args(argv)
    if args.model_parallel > 1 and "WORLD_SIZE" not in os.environ:
        from repro_torch.launch.mesh import spawn_ranks

        return spawn_ranks(main, argv, args.model_parallel)

    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_host_mesh

    dev = resolve_device(args.device)
    mesh = None
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        own_cards = dev.type == "cuda" and torch.cuda.device_count() >= world
        dist.init_process_group("nccl" if own_cards else "gloo",
                                init_method="env://")
        mesh = make_host_mesh(model=args.model_parallel, device=dev)
    try:
        return _serve(args, dev, mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _serve(args, dev, mesh) -> list:
    import dataclasses
    import time

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry as R
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.serve.server import Request, Server

    lead = not dist.is_initialized() or dist.get_rank() == 0
    cfg = R.get_arch(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(
        args.seed))
    if args.quant:
        from repro_torch.quant import lm_quant as Q
        params = Q.quantize_blocks(params)
        before, after = Q.quantized_bytes(params)
        if lead:
            print(f"C3 quantized serving: weight bytes {before/2**20:.1f} "
                  f"-> {after/2**20:.1f} MiB")
        # the server runs the blocks through the param_transform hook
        cfg = dataclasses.replace(cfg, quant_serving=True)
    srv = Server(cfg, params, device=dev, batch_slots=args.slots,
                 cache_len=args.cache_len, mesh=mesh)
    if lead and mesh is not None:
        print(f"arch={cfg.name} mesh="
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)

    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        srv.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))
    if dev.type == "cuda":
        build.library("flash_attention")     # compile before the clock
        build.library("codebook_matmul")
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = srv.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if lead:
        print(f"served {len(done)} requests / {toks} tokens in {dt:.1f}s "
              f"({toks/dt:.1f} tok/s) on {where}", flush=True)
    return done


if __name__ == "__main__":
    main()
