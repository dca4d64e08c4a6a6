"""Multi-pod dry run: every (architecture x input shape) cell traced on
a fake 256- or 512-rank world.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out dryrun_results.json

Port of `repro.launch.dryrun`, which lowers and compiles each cell for
512 placeholder XLA devices.  Here each cell runs in a process of its own
under a `fake` process group (`torch.testing`'s FakeStore: collectives
return at once, moving nothing) of exactly 256 ranks — the (16, 16)
("data", "model") mesh — or 512 — (2, 16, 16) ("pod", "data",
"model") — as rank 0, its step run once on fake CPU tensors
(`launch/steps.py` `trace_*`).  On CPU tensors the attention is the
plain route (the flash kernel's plain version), as the reference's CPU
dry run traces XLA's attention chain, not its Pallas kernel.  Each cell
prints the reference's row and JSON keys: `trace_s` (the trace's wall
seconds) stands for `lower_s` / `compile_s`; argument bytes are one
device's parameters, AdamW moments and batch (and caches for decode);
temp bytes the peak of the step's live temporaries on that device
(`trace_analysis.CostMode`), peak their sum; `collective_largest` the
largest single output of each collective kind; the roofline terms use the
H100 constants of `distributed/roofline.py`, analytic, not measured.
A cell whose step raises is FAILED, and any FAILED cell exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _fake_world(n: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             seq_parallel: bool = True, verbose: bool = True) -> dict:
    """One cell, traced in this process (which joins a fake world of 256
    or 512 ranks)."""
    from repro_torch.configs import registry as R
    from repro_torch.distributed import roofline as RL
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import steps as ST

    cfg = R.get_arch(arch)
    shape = R.get_shape(shape_name)
    ok, why = R.cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": _mesh_name(multi_pod), "status": "skipped",
                "reason": why}

    _fake_world(512 if multi_pod else 256)
    mesh = MESH.make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    batch = R.input_specs(cfg, shape)
    t0 = time.time()
    if shape.kind == "train":
        costs, arg_bytes = ST.trace_train(cfg, mesh, batch,
                                          seq_parallel=seq_parallel)
    elif shape.kind == "prefill":
        costs, arg_bytes = ST.trace_prefill(cfg, mesh, batch,
                                            cache_len=shape.seq_len)
    else:  # decode
        costs, arg_bytes = ST.trace_decode(cfg, mesh,
                                           batch=shape.global_batch,
                                           cache_len=shape.seq_len)
    t_trace = time.time() - t0
    report = RL.analyze_trace(f"{arch}/{shape_name}", costs,
                              model_flops=RL.model_flops_for(cfg, shape),
                              chips=chips)
    out = {
        "arch": arch,
        "shape": shape_name,
        "mesh": _mesh_name(multi_pod),
        "status": "ok",
        "trace_s": round(t_trace, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": None,
            "temp_bytes": costs.temp_bytes,
            "peak_bytes": costs.temp_bytes + arg_bytes,
        },
        "roofline": report.row(),
        "collective_largest": costs.largest,
    }
    if verbose:
        m = out["memory"]
        r = out["roofline"]
        print(f"[{out['mesh']}] {arch:24s} {shape_name:12s} "
              f"args={_gb(m['argument_bytes'])} temp={_gb(m['temp_bytes'])} "
              f"flops/dev={r['hlo_flops']:.3e} bytes/dev={r['hlo_bytes']:.3e} "
              f"coll={r['coll_bytes']:.3e} bound={r['bottleneck']} "
              f"(trace {out['trace_s']}s)", flush=True)
    return out


def _gb(x):
    return f"{x / 2**30:.2f}GiB" if x is not None else "?"


def _cell_in_subprocess(arch: str, shape: str, multi_pod: bool,
                        seq_parallel: bool) -> dict:
    """`run_cell` in a fresh process (a fake world per cell); FAILED with
    its error when the process fails."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cell.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", out]
        if multi_pod:
            cmd.append("--multi-pod")
        if not seq_parallel:
            cmd.append("--no-seq-parallel")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("["):
                print(line, flush=True)
        if proc.returncode == 0 or os.path.exists(out):
            with open(out) as f:
                rows = json.load(f)
            if rows:
                return rows[0]
        return {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod),
                "status": "FAILED",
                "error": (proc.stderr or proc.stdout)[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--jobs", type=int, default=4,
                    help="cells traced at once, each in its own process")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import registry as R

    if args.all:
        cells = [(a, s) for a in R.ARCH_NAMES for s in SHAPE_NAMES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    jobs = [(a, s, mp) for mp in meshes for a, s in cells]
    sp = not args.no_seq_parallel

    t0 = time.time()
    if len(jobs) == 1:
        arch, shape, mp = jobs[0]
        try:
            results = [run_cell(arch, shape, multi_pod=mp, seq_parallel=sp)]
        except Exception as e:  # a dry-run failure is a bug — surface it
            traceback.print_exc()
            results = [{"arch": arch, "shape": shape,
                        "mesh": _mesh_name(mp), "status": "FAILED",
                        "error": str(e)[-2000:]}]
    else:
        with ThreadPoolExecutor(max(1, args.jobs)) as pool:
            results = list(pool.map(
                lambda j: _cell_in_subprocess(*j, sp), jobs))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_fail = sum(1 for r in results if r["status"] == "FAILED")
    for r in results:
        if r["status"] == "FAILED":
            print(f"FAILED [{r['mesh']}] {r['arch']} {r['shape']}: "
                  f"{r['error'][-300:]}", flush=True)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), {n_fail} "
          f"FAILED in {time.time() - t0:.1f} s")
    if n_fail:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
