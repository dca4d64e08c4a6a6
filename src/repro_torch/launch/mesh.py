"""Device meshes: the production meshes of the dry run and a host mesh.

Port of `repro.launch.mesh`.  The mesh hierarchy maps the paper's NoC
hierarchy onto mesh axes:
  "model" = intra-domain TP/EP (the 20-core fullerene level-1 domain),
  "data"  = DP/FSDP across level-1 router domains,
  "pod"   = the level-2 router scale-up axis (multi-pod).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the default
process group, which the caller (or `make_host_mesh`, for a world of one)
has initialised.  Nothing is built at import.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

SINGLE_POD = (16, 16)                 # 256 devices
MULTI_POD = (2, 16, 16)               # 2 pods = 512 devices


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model"), over a default process group of exactly 256 or 512 ranks
    (the dry run's `fake` backend)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"need a world of {n} ranks, have {have} — the dry run must "
            f"init_process_group('fake', world_size={n}) first "
            f"(launch/dryrun.py)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device=None):
    """("data", "model") = (world // model, model) over the default
    process group, on the entry point's device (the card unless
    device="cpu").  Without a process group, a world of one is started
    (NCCL on the card, gloo on the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"model parallelism {model} does not divide the "
                         f"world of {n} ranks")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        stage_gloo_collectives_through_host()
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def spawn_ranks(entry, argv, world: int) -> None:
    """Run `entry(argv)` (a launcher's `main`) on `world` ranks spawned
    on this host, each with the variables `torchrun` sets (WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR / MASTER_PORT on a free localhost
    port), so `entry` joins them as torchrun's; raises unless every rank
    exits 0."""
    import multiprocessing as mp
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(entry, argv, r, world, port))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"--model-parallel {world}: rank exit codes "
                           f"{codes}")


def _rank(entry, argv, rank: int, world: int, port: int) -> None:
    import os

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    entry(argv)


_STAGED: list = []
_STAGED_OPS = ("all_gather_into_tensor", "reduce_scatter_tensor",
               "all_reduce", "all_to_all_single", "broadcast")


def stage_gloo_collectives_through_host() -> None:
    """Run the functional collectives DTensor issues on CUDA tensors
    through host memory: each copies its CUDA operand to the host, runs
    the collective there (gloo's CPU path) and copies the result back.
    Ranks that share one card cannot use NCCL (it refuses two ranks on
    one device), and gloo's own CUDA path of `all_gather_into_tensor`
    ends the process with a segmentation fault (torch 2.11, H100), so a
    process whose group is gloo on the card takes this path for every
    collective; the values are those of the host collective (no cast:
    bf16 stays bf16).  Idempotent; kernels registered for the CUDA
    dispatch key of `_c10d_functional`, for the life of the process."""
    if _STAGED:
        return
    ops = torch.ops._c10d_functional
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def staged(name):
        op = getattr(ops, name).default

        def impl(*args):
            host = [a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args]
            out = ops.wait_tensor.default(op(*host))
            return out.to(args[0].device)
        return impl

    for name in _STAGED_OPS:
        lib.impl(name, staged(name), "CUDA")

    def all_reduce_(t, reduce_op, group_name):
        out = ops.wait_tensor.default(
            ops.all_reduce.default(t.cpu(), reduce_op, group_name))
        return t.copy_(out)

    lib.impl("all_reduce_", all_reduce_, "CUDA")
    _STAGED.append(lib)
