#!/usr/bin/env python
"""Where one dry-run cell's counts come from, op by op.

    PYTHONPATH=src python scripts/torch_dryrun_attribute.py \
        --arch zamba2-2.7b --shape train_4k [--multi-pod] [--top 12]

Traces the cell as `python -m repro_torch.launch.dryrun` does (a fake
256- or 512-rank world, one step on fake CPU tensors) with a
`trace_analysis.CostMode` that also files every count under the aten op
and the call site (the two innermost frames of `repro_torch`, and "bwd"
for an op the autograd engine runs): FLOPs, collective output bytes by
kind with the bytes a device receives for them
(`torch_dryrun_compare.wire_bytes`, the group size from the op's process
group), and the storages live at the temp-bytes peak.  Prints the cell's
row line, then the top sites of each.  Analytic counts of one device,
not card times.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import os
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.distributed import trace_analysis as TA  # noqa: E402
from torch_dryrun_compare import wire_bytes  # noqa: E402


def _group_size(args) -> int:
    """The ranks of a collective's process group, from the group name
    the `_c10d_functional` / `_dtensor` op takes."""
    from torch.distributed import distributed_c10d as C10D

    name = [a for a in args if isinstance(a, str)][-1]
    return C10D._resolve_process_group(name).size()


def _site() -> str:
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename
              and "trace_analysis" not in f.filename]
    where = " < ".join(f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"
                       for f in frames[-2:][::-1])
    node = torch._C._current_autograd_node()
    return ("bwd " if node is not None else "") + where


class AttributingMode(TA.CostMode):
    """`CostMode` that files its counts by (op, site)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.flops_by = collections.Counter()
        self.coll_by = collections.Counter()
        self.wire_by = collections.Counter()
        self.made_by = {}
        self.at_peak = {}
        self._op = self._where = None

    def _track(self, out) -> None:
        key = out.untyped_storage()._cdata
        if key not in self._storages:
            self.made_by[key] = (self._op, tuple(out.shape), self._where)
        peak = self.peak
        super()._track(out)
        if self.peak > peak * 1.01 + 2 ** 20:
            self._sweep()
            self.at_peak = {k: (n, self.made_by.get(k))
                            for k, (_, n) in self._storages.items()}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func._overloadpacket.__name__
        self._where = _site()
        flops, coll = self.flops, dict(self.per_kind)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.flops != flops:
            self.flops_by[(self._op, self._where)] += self.flops - flops
        for kind, n in self.per_kind.items():
            if n != coll[kind]:
                key = (kind, self._op, self._where)
                self.coll_by[key] += n - coll[kind]
                self.wire_by[key] += wire_bytes(kind, n - coll[kind],
                                                _group_size(args))
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    modes = []

    def trace(fn, match_elems=None, fake_mode=None):
        mode = AttributingMode(match_elems, fake_mode)
        with TA.mesh_alltoall() if fake_mode is not None else \
                contextlib.nullcontext(), mode:
            result = fn()
        del result
        modes.append(mode)
        return mode.costs()

    TA.trace = trace
    from repro_torch.launch import dryrun

    row = dryrun.run_cell(args.arch, args.shape, multi_pod=args.multi_pod)
    if row["status"] != "ok":
        print(row)
        return
    (m,) = modes
    print(f"\nFLOPs {m.flops:.4g}, by op and site:")
    for (op, where), n in m.flops_by.most_common(args.top):
        print(f"  {n:.4g}  {n / m.flops:6.1%}  {op}  {where}")
    total = sum(m.per_kind.values())
    print(f"\ncollective bytes {total:.4g}, wire bytes "
          f"{sum(m.wire_by.values()):.4g}, by kind, op and site, output "
          f"then wire bytes:")
    for key, n in m.coll_by.most_common(args.top):
        kind, op, where = key
        print(f"  {n:.4g}  {n / total:6.1%}  {m.wire_by[key]:.4g}  {kind} "
              f"({op})  {where}")
    by_site = collections.Counter()
    for n, made in m.at_peak.values():
        by_site[(made[0], made[2]) if made else ("?", "?")] += n
    print(f"\ntemp bytes {m.peak:.4g} at the peak, live storages by op "
          f"and site:")
    for (op, where), n in by_site.most_common(args.top):
        print(f"  {n:.4g}  {n / m.peak:6.1%}  {op}  {where}")


if __name__ == "__main__":
    main()
