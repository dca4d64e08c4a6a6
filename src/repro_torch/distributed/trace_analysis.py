"""Per-device FLOPs, HBM bytes and collective bytes of one traced step.

The counterpart of the reference's `repro.distributed.hlo_analysis`,
which reads them from a step's post-SPMD optimized HLO.  The port has no
compiled program to read: it runs the step once, eagerly, on fake tensors
(`launch/steps.py` `trace_*`) and counts every aten op a device executes,
through a `TorchDispatchMode`.  The reference's rules, on aten ops:

  * FLOPs: matmul-class ops (mm, addmm, bmm, baddbmm) = 2 * output
    elements * contraction length; convolution = 2 * output elements *
    (input channels per group * kernel window), and its backward the same
    for each gradient it computes.  Elementwise flops are ignored.
  * HBM bytes: each op is one kernel; its traffic is the bytes of its
    tensor operands plus its outputs.  Views and other free ops (shape
    queries, allocation without a fill) cost nothing.  An in-place write
    into a slice (`copy_`, `index_copy_`, `index_put_`: the
    dynamic-update-slice analogue) costs 2 x the slice, and a row gather
    (`index_select`, `embedding`: the dynamic-slice analogue) 2 x what it
    gathers.
  * Collectives: output bytes per `_c10d_functional` op and per
    DTensor all-to-all (`_dtensor.shard_dim_alltoall`: one device's
    shard), bucketed by kind, counted apart from HBM bytes; the largest
    single output of each kind is kept too.
  * Temp bytes: the peak of the bytes of live storages that the step's
    ops made.  A storage lives while any tensor holds it, not only the
    op's output object: autograd keeps a saved output, and a
    rematerialising checkpoint its cached products, through tensors of
    their own on the same storage (`CostMode._track`).

The counts are per device: the mode lets DTensor run first (it returns
NotImplemented for DTensor operands, as `CommDebugMode` does), so it sees
the local shard ops and the redistributions' collectives, never the
global shapes.  DTensor's own shape propagation runs on meta tensors or
on fake tensors of its own fake mode, which are skipped: a traced step
on fake tensors names its mode (`fake_mode`), and a step on real tensors
counts no fake one.  An eager trace runs every layer, so the reference's
while-loop trip-count recovery has no counterpart.

A DTensor moving a shard from one tensor dim to another (Shard(i) ->
Shard(j)) issues an all-to-all on a CUDA mesh, but on a CPU mesh, as the
dry run's fake world is, torch falls back to an all-gather of the whole
dim and a chunk of it.  A trace on fake tensors takes the all-to-all
(`mesh_alltoall`), so it counts the step a mesh of cards runs: no
gathered buffer, the all-to-all's output bytes.  Real gloo ranks keep
torch's fallback, which is what they run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_MATMULS = {"mm", "addmm", "bmm", "baddbmm"}
_SLICE_WRITES = {"copy_", "index_copy_", "index_copy", "index_put_",
                 "index_put", "slice_scatter", "select_scatter"}
_SOURCE_ARG = {"index_copy_": 3, "index_copy": 3, "index_put_": 2,
               "index_put": 2}
_ROW_GATHERS = {"index_select", "embedding"}
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "_unsafe_view", "lift_fresh",
         "lift_fresh_copy", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "_local_scalar_dense", "detach", "alias",
         "is_same_size", "_has_compatible_shallow_copy_type", "device",
         "wait_tensor", "set_", "resize_"}


def _kind(name: str) -> str | None:
    """The collective kind of a `_c10d_functional` op name, or None."""
    for key, kind in (("all_gather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"),
                      ("all_to_all", "all-to-all"),
                      ("alltoall", "all-to-all"),
                      ("broadcast", "collective-permute"),
                      ("permute", "collective-permute")):
        if key in name:
            return kind
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class TraceCosts:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    per_kind: dict
    op_counts: dict
    temp_bytes: float = 0.0      # peak of the step's live temporaries
    matched_bytes: float = 0.0   # traffic of tensors of `match_elems`
                                 # elements (kernel-adjusted accounting)
    n_ops: int = 0
    largest: dict = dataclasses.field(default_factory=dict)  # by kind


def _matmul_flops(name: str, args, out) -> float:
    lhs = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * lhs.shape[-1]


def _conv_flops(args, out) -> float:
    w = args[1]
    return 2.0 * out.numel() * math.prod(w.shape[1:])


class CostMode(TorchDispatchMode):
    """Counts one device's FLOPs, HBM bytes, collective bytes and live
    temporary bytes over the ops run inside it."""

    def __init__(self, match_elems: int | None = None, fake_mode=None):
        super().__init__()
        self.match_elems = match_elems
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.hbm = 0.0
        self.matched = 0.0
        self.per_kind = {k: 0.0 for k in COLLECTIVES}
        self.op_counts = {k: 0 for k in COLLECTIVES}
        self.largest = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self.n_ops = 0
        self._storages = {}         # storage key -> (weak ref, bytes)
        self._orphans = set()       # keys whose output object has died

    def _track(self, out) -> None:
        """Count `out`'s storage live until no tensor holds it.  When the
        output object dies its storage may live on (a saved output, a
        checkpoint's cached product): it is an orphan, checked whenever
        the live bytes would set a new peak."""
        storage = out.untyped_storage()
        key = storage._cdata
        if key in self._storages:
            return
        n = _nbytes(out)
        self._storages[key] = (StorageWeakRef(storage), n)
        weakref.finalize(out, self._orphans.add, key)
        self.live += n
        if self.live > self.peak:
            self._sweep()
            self.peak = max(self.peak, self.live)

    def _sweep(self) -> None:
        """Drop the orphans whose storage no tensor holds any more."""
        for key in [k for k in self._orphans
                    if self._storages[k][0].expired()]:
            self._orphans.discard(key)
            self.live -= self._storages.pop(key)[1]

    def _traffic(self, tensors) -> float:
        total = 0
        for t in tensors:
            n = _nbytes(t)
            total += n
            if self.match_elems and t.numel() == self.match_elems:
                self.matched += n
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor run its local ops
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(t.device.type == "meta" or (
                is_fake(t) and t.fake_mode is not self.fake_mode)
               for t in ins + outs):
            return out                  # DTensor's shape propagation
        packet = func._overloadpacket
        name = packet.__name__
        ns = getattr(func, "namespace", "")
        self.n_ops += 1
        if ns in ("_c10d_functional", "_dtensor") and name != "wait_tensor":
            kind = _kind(name)
            if kind is not None:
                n = sum(_nbytes(t) for t in outs)
                self.per_kind[kind] += n
                self.op_counts[kind] += 1
                self.largest[kind] = max(self.largest[kind], n)
                for t in outs:
                    self._track(t)
            return out
        if name in _FREE or ns == "prim" or getattr(func, "is_view", False):
            return out
        aliased = any(r.alias_info is not None
                      for r in func._schema.returns)
        if not aliased:
            for t in outs:
                self._track(t)
        if name in _MATMULS:
            self.flops += _matmul_flops(name, args, outs[0])
        elif name == "convolution":
            self.flops += _conv_flops(args, outs[0])
        elif name == "convolution_backward":
            grad_out, x, w = args[0], args[1], args[2]
            mask = args[-1]
            fwd = 2.0 * grad_out.numel() * math.prod(w.shape[1:])
            self.flops += fwd * sum(bool(m) for m in mask[:2])
        if name in _SLICE_WRITES:
            src = args[_SOURCE_ARG.get(name, 1)]
            self.hbm += 2 * self._traffic([src])
            return out
        if name in _ROW_GATHERS:
            self.hbm += 2 * self._traffic(outs)
            return out
        self.hbm += self._traffic(ins) + self._traffic(outs)
        return out

    def costs(self) -> TraceCosts:
        return TraceCosts(
            flops=self.flops, hbm_bytes=self.hbm,
            coll_bytes=sum(self.per_kind.values()),
            per_kind=dict(self.per_kind), op_counts=dict(self.op_counts),
            temp_bytes=float(self.peak), matched_bytes=self.matched,
            n_ops=self.n_ops, largest=dict(self.largest))


@contextlib.contextmanager
def mesh_alltoall():
    """Within, DTensor's Shard(i) -> Shard(j) redistribution issues the
    all-to-all (`_dtensor.shard_dim_alltoall`) on any mesh, as it does on
    a CUDA mesh, instead of the CPU mesh's all-gather and chunk.  For
    steps on fake tensors, whose collectives move nothing."""
    from torch.distributed.tensor import _collective_utils as CU
    from torch.distributed.tensor import placement_types as PT

    def alltoall(local, gather_dim, shard_dim, mesh, mesh_dim):
        group = mesh.get_group(mesh_dim).group_name
        return torch.ops._dtensor.shard_dim_alltoall(local, gather_dim,
                                                     shard_dim, group)

    saved = {m: m.shard_dim_alltoall for m in (CU, PT)
             if hasattr(m, "shard_dim_alltoall")}
    try:
        for m in saved:
            m.shard_dim_alltoall = alltoall
        yield
    finally:
        for m, f in saved.items():
            m.shard_dim_alltoall = f


def trace(fn, match_elems: int | None = None, fake_mode=None) -> TraceCosts:
    """Run `fn()` once under a `CostMode` and return its counts;
    `fake_mode` is the mode of the fake tensors the step runs on (its
    redistributions then take the all-to-all, `mesh_alltoall`)."""
    mode = CostMode(match_elems, fake_mode)
    with mesh_alltoall() if fake_mode is not None else \
            contextlib.nullcontext(), mode:
        result = fn()
    del result
    return mode.costs()
