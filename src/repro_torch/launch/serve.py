"""Serving launcher: batched prefill + greedy decode on one card.

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
"""
from __future__ import annotations

import argparse


def main(argv=None) -> list:
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
    args = ap.parse_args(argv)

    import dataclasses
    import time

    import numpy as np
    import torch

    from repro_torch.configs import registry as R
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.serve.server import Request, Server

    dev = resolve_device(args.device)
    cfg = R.get_arch(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(
        args.seed))
    if args.quant:
        from repro_torch.quant import lm_quant as Q
        params = Q.quantize_blocks(params)
        before, after = Q.quantized_bytes(params)
        print(f"C3 quantized serving: weight bytes {before/2**20:.1f} -> "
              f"{after/2**20:.1f} MiB")
        # the server runs the blocks through the param_transform hook
        cfg = dataclasses.replace(cfg, quant_serving=True)
    srv = Server(cfg, params, device=dev, batch_slots=args.slots,
                 cache_len=args.cache_len)

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
    print(f"served {len(done)} requests / {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s) on {where}")
    return done


if __name__ == "__main__":
    main()
