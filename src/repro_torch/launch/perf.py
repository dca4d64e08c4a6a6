"""Perf-iteration harness: re-trace one (arch x shape) cell with named
optimization variants and report the roofline-term deltas vs baseline.

    PYTHONPATH=src python -m repro_torch.launch.perf \\
        --arch moonshot-v1-16b-a3b --shape train_4k \\
        --variants baseline,moe_group_big --json out.json

Port of `repro.launch.perf`: the same named variants, each one
hypothesis, traced as the dry run traces a cell (`launch/dryrun.py`: a
fake world of 256 or 512 ranks, one step on fake tensors) and priced with
the H100 constants of `distributed/roofline.py` — analytic, not measured.
`flash_kernel` and `pure_fsdp_flash` re-account the attention-score
traffic as the flash kernel's own I/O (`kernels/flash_attention.py`
`hbm_io_bytes`): the trace runs the kernel's plain version on the CPU,
whose (B, H, S, S) scores the kernel keeps on chip.  `remat_dots`
rematerialises a train cell's blocks saving their 2-D products
(`models.transformer.REMAT_POLICIES`); on prefill and decode cells, which
run no backward, it traces the baseline's numbers, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

def apply_variant(cfg, name: str):
    """Named optimization variants (each = one hypothesis); returns
    (cfg, options)."""
    from repro_torch.distributed.sharding import FSDP_RULES, ShardingRules

    r = dataclasses.replace
    table = {
        "baseline": (cfg, {}),
        "attn_chunk": (r(cfg, attn_chunk=1024), {}),
        "attn_chunk_2k": (r(cfg, attn_chunk=2048), {}),
        "moe_group_big": (r(cfg, moe_group_size=4096), {}),
        "moe_group_small": (r(cfg, moe_group_size=256), {}),
        "moe_group_128": (r(cfg, moe_group_size=128), {}),
        "moe_group_512": (r(cfg, moe_group_size=512), {}),
        "moe_small_cf1": (r(cfg, moe_group_size=256, capacity_factor=1.0),
                          {}),
        "remat_dots": (r(cfg, moe_group_size=256, remat_policy="dots"), {}),
        "gs256_no_sp": (r(cfg, moe_group_size=256), {"seq_parallel": False}),
        "no_seq_parallel": (cfg, {"seq_parallel": False}),
        "ffn_out_rs": (r(cfg, constrain_ffn_out=True), {}),
        "ffn_out_rs_chunk": (r(cfg, constrain_ffn_out=True, attn_chunk=1024),
                             {}),
        "kv_int8": (r(cfg, kv_cache_dtype=torch.int8), {}),
        "quant_serving": (r(cfg, quant_serving=True), {}),
        "quant4_serving": (r(cfg, quant_serving="4bit"), {}),
        "quant_serving_kv8": (r(cfg, quant_serving=True,
                                kv_cache_dtype=torch.int8), {}),
        # sliding-window-bounded KV cache (hybrid long-context decode)
        "win_cache": (r(cfg, attn_chunk=0), {"window_cache": True}),
        "pure_fsdp": (cfg, {"rules": ShardingRules(FSDP_RULES)}),
        "pure_fsdp_flash": (cfg, {"rules": ShardingRules(FSDP_RULES),
                                  "flash_adjust": True}),
        # the flash kernel replaces the attention chain on the card; the
        # CPU trace keeps the plain chain and re-accounts its scores
        "flash_kernel": (cfg, {"flash_adjust": True}),
    }
    if name not in table:
        raise ValueError(name)
    return table[name]


def run_variant(arch: str, shape_name: str, variant: str,
                multi_pod: bool = False) -> dict:
    from repro_torch.configs import registry as R
    from repro_torch.distributed import roofline as RL
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import steps as ST

    cfg = R.get_arch(arch)
    shape = R.get_shape(shape_name)
    cfg, opts = apply_variant(cfg, variant)
    DR._fake_world(512 if multi_pod else 256)
    mesh = MESH.make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    batch = R.input_specs(cfg, shape)
    rules = opts.get("rules", ShardingRules())
    match = _score_elems(cfg, shape, mesh, opts) \
        if opts.get("flash_adjust") else None
    if shape.kind == "train":
        costs, args = ST.trace_train(
            cfg, mesh, batch, seq_parallel=opts.get("seq_parallel", True),
            rules=rules, match_elems=match)
    elif shape.kind == "prefill":
        costs, args = ST.trace_prefill(cfg, mesh, batch,
                                       cache_len=shape.seq_len,
                                       match_elems=match)
    else:
        cache_len = shape.seq_len
        if opts.get("window_cache") and cfg.sliding_window:
            cache_len = cfg.sliding_window
        costs, args = ST.trace_decode(cfg, mesh, batch=shape.global_batch,
                                      cache_len=cache_len,
                                      match_elems=match)
    rep = RL.analyze_trace(f"{arch}/{shape_name}/{variant}", costs,
                           model_flops=RL.model_flops_for(cfg, shape),
                           chips=chips)
    if opts.get("flash_adjust"):
        rep = _flash_adjust(rep, cfg, shape, costs, mesh,
                            pure_fsdp="rules" in opts)
    row = rep.row()
    row["variant"] = variant
    row["temp_gib"] = round(costs.temp_bytes / 2**30, 2)
    row["args_gib"] = round(args / 2**30, 2)
    return row


def _local_batch_heads(cfg, shape, mesh, pure_fsdp: bool):
    from repro_torch.distributed.sharding import mesh_sizes

    sizes = mesh_sizes(mesh)
    tp = 1 if pure_fsdp else sizes.get("model", 1)
    dp = mesh.size() // tp
    return max(shape.global_batch // dp, 1), max(cfg.n_heads // tp, 1)


def _score_elems(cfg, shape, mesh, opts) -> int:
    """Elements of one device's (B, H, S, S) attention-score tensor."""
    b_loc, h_loc = _local_batch_heads(cfg, shape, mesh, "rules" in opts)
    return b_loc * h_loc * shape.seq_len * shape.seq_len


def _flash_adjust(rep, cfg, shape, costs, mesh, pure_fsdp=False):
    """Re-account attention-score traffic as flash-kernel I/O: remove the
    traced traffic of every tensor of the per-device score size
    (B_loc x H_loc x S x S) and add the kernel's analytic q / k / v / o
    (and gradients) HBM I/O."""
    from repro_torch.kernels.flash_attention import hbm_io_bytes

    b_loc, h_loc = _local_batch_heads(cfg, shape, mesh, pure_fsdp)
    s = shape.seq_len
    io = hbm_io_bytes(b_loc, h_loc, s, s, cfg.hd,
                      with_backward=(shape.kind == "train")) * cfg.n_layers
    rep.bytes_accessed = costs.hbm_bytes - costs.matched_bytes + io
    rep.name += (f" [flash-adjusted: -{costs.matched_bytes/1e9:.0f}GB "
                 f"scores +{io/1e9:.0f}GB kernel IO]")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    rows = []
    base = None
    for v in args.variants.split(","):
        r = run_variant(args.arch, args.shape, v, args.multi_pod)
        if v == "baseline":
            base = r
        rows.append(r)
        delta = ""
        if base is not None and v != "baseline":
            key = {"compute": "t_compute_s", "memory": "t_memory_s",
                   "collective": "t_collective_s"}[base["bottleneck"]]
            delta = (f"  dominant({base['bottleneck']}) "
                     f"{base[key]:.4f}s -> {r[key]:.4f}s "
                     f"({(1 - r[key]/max(base[key],1e-12))*100:+.1f}% better)")
        print(f"{v:20s} comp={r['t_compute_s']:.4f}s mem={r['t_memory_s']:.4f}s "
              f"coll={r['t_collective_s']:.4f}s bound={r['bottleneck']} "
              f"temp={r['temp_gib']}GiB frac={r['roofline_fraction']:.3f}"
              f"{delta}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1, default=str)
    return rows


if __name__ == "__main__":
    main()
