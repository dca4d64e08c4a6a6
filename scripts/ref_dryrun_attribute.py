#!/usr/bin/env python
"""Where one of the reference's dry-run cells gets its counts, op by op.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/ref_dryrun_attribute.py \
        --arch mamba2-130m --shape prefill_32k [--multi-pod] [--top 12]

Lowers and compiles the cell as `python -m repro.launch.dryrun` does (512
placeholder XLA devices on the CPU, the (16, 16) or (2, 16, 16) mesh),
prints the cell's row line, then reads the compiled module's optimized
HLO with `repro.distributed.hlo_analysis` and lists its top ops, each
scaled by the trip counts of the while loops around it (the analysis's
own rule):

* FLOPs: every `dot` and `convolution`;
* collective bytes: every collective's output, by kind, and the bytes
  a device receives for it (`torch_dryrun_compare.wire_bytes`, the
  group size from its `replica_groups`); and the bytes of the
  all-gathers, all-to-alls and permutes that move bf16 values as f32
  (their operand widened from bf16, or every user rounding them back),
  with the total counted in the values' own type;
* the loop fusions whose `op_name` ends in `dot_general`: products XLA
  rewrote out of `dot` (at a batch of one row), which the analysis, and
  so the reference's row, counts as no FLOPs; their output shapes;
* the largest op outputs (the candidates for the temp peak: XLA's
  `memory_analysis` gives only the total, not the buffers it is made of),
  once per op, not scaled.

Each line carries the op's `op_name` (the jaxpr path), and its source
line where the HLO metadata has one.  The reference's counterpart of
`scripts/torch_dryrun_attribute.py`; analytic counts of one device, not
device times.
"""
from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import argparse  # noqa: E402
import collections  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.distributed import hlo_analysis as HA  # noqa: E402
from repro.distributed import roofline as RL  # noqa: E402
from torch_dryrun_compare import wire_bytes  # noqa: E402

_NAME_RE = re.compile(r'op_name="([^"]*)"')
_SRC_RE = re.compile(r'source_file="([^"]*)" source_line=(\d+)')


def _where(op: HA.Op) -> str:
    """The op's jaxpr path (its last three steps) and its source line
    where the metadata holds one."""
    name = _NAME_RE.search(op.rest)
    src = _SRC_RE.search(op.rest)
    path = "/".join(name.group(1).split("/")[-3:]) if name else "?"
    if src:
        path += f"  {src.group(1).split('src/')[-1]}:{src.group(2)}"
    return path


def _rewritten_dot(op: HA.Op) -> bool:
    """Whether `op` is a loop fusion whose jaxpr path ends in a
    dot_general: a product XLA rewrote into elementwise code (at M = 1, a
    batch of one row, it turns `bsd,dk->bsk` into a multiply and a
    reduce), which `hlo_analysis` counts as no dot."""
    name = _NAME_RE.search(op.rest)
    return (op.opcode == "fusion" and "kind=kLoop" in op.rest
            and name is not None and name.group(1).endswith("dot_general"))


_MOVES = ("all-gather", "all-to-all", "collective-permute")
# ops that move values without changing them, followed to a convert
_LAYOUT = {"bitcast", "copy", "reshape", "transpose", "slice", "broadcast",
           "concatenate", "pad", "dynamic-slice"}


def _operands(op: HA.Op) -> list:
    return HA._OPERAND_RE.findall(op.rest.split("), ")[0])


def _called(op: HA.Op, comps: dict) -> list:
    m = re.search(r"calls=%([\w.\-]+)", op.rest)
    return comps.get(m.group(1), []) if op.opcode == "fusion" and m else []


def _bf16_as_f32(op: HA.Op, symbols: dict, comps: dict) -> bool:
    """Whether f32 `op` holds bf16 values: a convert from bf16, reached
    from it (a fusion from its root, the last op XLA prints) through ops
    that only move values."""
    inner = _called(op, comps)
    op = inner[-1] if inner else op
    for _ in range(16):
        args = [symbols.get(a) for a in _operands(op)]
        if op.opcode == "convert":
            return bool(args) and args[0] is not None \
                and args[0].type_str.startswith("bf16")
        if op.opcode not in _LAYOUT or not args or args[0] is None:
            return False
        op = args[0]
    return False


def _rounded_to_bf16(name: str, user: HA.Op, symbols: dict, comps: dict,
                     users: dict) -> bool:
    """Whether `user` rounds its operand `name` to bf16 before any other
    use: a convert to bf16, or a fusion whose parameter for it feeds only
    such converts."""
    if user.opcode == "convert":
        return user.type_str.startswith("bf16")
    inner = _called(user, comps)
    if not inner or name not in _operands(user):
        return False
    i = _operands(user).index(name)
    param = next((o for o in inner if o.opcode == "parameter"
                  and o.rest.startswith(f"{i})")), None)
    uses = users.get(param.name, ()) if param is not None else ()
    return bool(uses) and all(u.opcode == "convert"
                              and u.type_str.startswith("bf16")
                              for u in uses)


def _widened(op: HA.Op, symbols: dict, comps: dict, users: dict) -> bool:
    """Whether collective `op` moves bf16 values in f32: an all-gather,
    all-to-all or permute of f32 whose operand is bf16 widened (XLA:CPU
    runs a bf16 product in f32 and widens its operands before their
    collectives) or whose every user rounds it back to bf16 first."""
    if not (op.opcode.startswith(_MOVES) and op.type_str.startswith("f32")):
        return False
    args = [symbols.get(a) for a in _operands(op)]
    if args and args[0] is not None and _bf16_as_f32(args[0], symbols,
                                                     comps):
        return True
    out = users.get(op.name, ())
    return bool(out) and all(_rounded_to_bf16(op.name, u, symbols, comps,
                                              users) for u in out)


def _multipliers(ops: list, entry: str, trips: dict) -> dict:
    """{computation: product of the trip counts of the while loops around
    it} for the entry and every while body (the computations
    `hlo_analysis.analyze` prices), from the analysis's own trip counts
    (`HloCosts.trip_counts`, one for each body)."""
    parent = {}
    for o in ops:
        m = re.search(r"body=%?([\w.\-]+)", o.rest)
        if o.opcode == "while" and m:
            parent[m.group(1)] = o.comp

    def mult(comp, depth=0):
        if comp == entry or depth > 10 or comp not in parent:
            return 1
        return trips.get(comp, 1) * mult(parent[comp], depth + 1)

    return {c: mult(c) for c in {entry} | set(parent)}


def _group_size(op: HA.Op) -> int:
    """The devices in one replica group of a collective: the iota form
    `replica_groups=[groups,size]<=[...]`, or the first listed group; a
    permute (source-target pairs) counts as a group of 2."""
    m = re.search(r"replica_groups=\[\d+,(\d+)\]<=", op.rest)
    if m:
        return int(m.group(1))
    m = re.search(r"replica_groups=\{\{([0-9,]*)\}", op.rest)
    return len(m.group(1).split(",")) if m else 2


def _dot_flops(op: HA.Op, symbols: dict) -> float:
    """`hlo_analysis.analyze`'s count for one dot or convolution."""
    out = HA._shape_dims(op.type_str)
    if not out:
        return 0.0
    m = math.prod(out[0]) if out[0] else 1
    if op.opcode == "convolution":
        wm = re.search(r"window=\{size=([0-9x]+)", op.rest)
        win = math.prod(int(d) for d in wm.group(1).split("x")) if wm else 1
        return 2.0 * m * win
    refs = HA._OPERAND_RE.findall(op.rest)
    cdims = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", op.rest)
    if not (refs and cdims):
        return 0.0
    k = 1
    lhs = symbols.get(refs[0])
    ldims = HA._shape_dims(lhs.type_str) if lhs is not None else None
    if ldims:
        for ci in cdims.group(1).split(","):
            if ci:
                k *= ldims[0][int(ci)]
    return 2.0 * m * k


def attribute(text: str, top: int) -> None:
    ops, meta = HA.parse_module(text)
    symbols = {o.name: o for o in ops}
    comps, users = collections.defaultdict(list), collections.defaultdict(
        list)
    for o in ops:
        comps[o.comp].append(o)
        for ref in set(_operands(o)):
            users[ref].append(o)
    costs = HA.analyze(text)
    mults = _multipliers(ops, meta["entry"], costs.trip_counts)
    flops = collections.Counter()
    coll = collections.Counter()
    wire = collections.Counter()
    sizes = []
    rewritten = collections.Counter()
    widened = 0.0
    for o in ops:
        if o.comp not in mults:
            continue
        k = mults[o.comp]
        base = next((c for c in HA.COLLECTIVES if o.opcode.startswith(c)),
                    None)
        if base is not None and not o.opcode.endswith("-done"):
            n = HA._shape_bytes(o.type_str) * k
            coll[(base, k, _where(o))] += n
            if _widened(o, symbols, comps, users):
                widened += n
            wire[(base, k, _where(o))] += wire_bytes(base, n, _group_size(o))
            continue
        if o.opcode in ("dot", "convolution"):
            flops[(o.opcode, k, _where(o))] += _dot_flops(o, symbols) * k
        elif _rewritten_dot(o):
            rewritten[(o.type_str.split("{")[0], k, _where(o))] += 1
        if o.opcode not in HA._FREE_OPS:
            sizes.append((HA._shape_bytes(o.type_str), o.opcode,
                          o.type_str.split("{")[0], _where(o)))
    total = sum(flops.values())
    print(f"\nFLOPs {total:.4g} (the analysis's total {costs.flops:.4g}), "
          f"by op (x trip count) and site:")
    for (opcode, k, where), n in flops.most_common(top):
        print(f"  {n:.4g}  {n / total:6.1%}  {opcode} x{k}  {where}")
    total = sum(coll.values())
    print(f"\ncollective bytes {total:.4g} (the analysis's total "
          f"{costs.coll_bytes:.4g}), wire bytes {sum(wire.values()):.4g}, "
          f"by kind (x trip count) and site, output then wire bytes:")
    for (kind, k, where), n in coll.most_common(top):
        print(f"  {n:.4g}  {n / total:6.1%}  {wire[(kind, k, where)]:.4g}"
              f"  {kind} x{k}  {where}")
    print(f"of which bf16 values moved as f32 (XLA:CPU widens a bf16 "
          f"product's operands before their collectives): {widened:.4g}; "
          f"in the values' own type the total is "
          f"{total - widened / 2:.4g}")
    print("\nloop fusions of a dot_general (products XLA rewrote out of "
          "`dot`, which the analysis counts as no FLOPs), by output shape "
          "(x trip count) and site:")
    for (shape, k, where), n in sorted(rewritten.items())[:top]:
        print(f"  {shape} x{k}{f' ({n} ops)' if n > 1 else ''}  {where}")
    if not rewritten:
        print("  none")
    print("\nlargest op outputs (temp candidates), bytes once:")
    for n, opcode, shape, where in sorted(sizes, reverse=True)[:top]:
        print(f"  {n:.4g}  {opcode} {shape}  {where}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    texts = []
    analyze = RL.analyze_compiled

    def keeping_text(name, lowered, compiled, **kw):
        texts.append(compiled.as_text())
        return analyze(name, lowered, compiled, **kw)

    RL.analyze_compiled = keeping_text
    from repro.launch import dryrun

    row = dryrun.run_cell(args.arch, args.shape, multi_pod=args.multi_pod)
    if row["status"] != "ok":
        print(row)
        return
    attribute(texts[0], args.top)


if __name__ == "__main__":
    main()
