#!/usr/bin/env python
"""Cell-by-cell ratios of the port's dry run to the reference's.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
        --out port.json
    PYTHONPATH=src python -m repro.launch.dryrun --all --both-meshes \
        --out ref.json
    python scripts/torch_dryrun_compare.py port.json ref.json \
        [--before old.json]

Prints a markdown table, a row for each (arch, shape) and a column for
each mesh: the port's FLOPs, HBM bytes, collective bytes and temp bytes
a device over the reference's, or the two statuses where either did
not run it, and one line for the cells both skip (with `--before`, an older port table's ratio beside each
that moved by more than 10 %); then the cells outside 0.5-2x in FLOPs,
collective bytes or temp bytes.  Both tables are analytic, at the constants each
package's roofline names (H100 for the port); no number here is a card
time.
"""
from __future__ import annotations

import argparse
import json

BAND = (0.5, 2.0)
TERMS = (("FLOPs", "roofline", "hlo_flops"), ("HBM", "roofline", "hlo_bytes"),
         ("coll", "roofline", "coll_bytes"), ("temp", "memory", "temp_bytes"))


MESHES = ("16x16", "2x16x16")


def wire_bytes(kind: str, out_bytes: float, n: int) -> float:
    """Bytes one device receives in a collective of `kind` over a group
    of n devices whose output on that device is `out_bytes`, by the ring
    algorithms' counts: an all-gather or an all-to-all receives
    (n - 1) / n of its output, a reduce-scatter n - 1 times its output
    (one shard of the reduced tensor), an all-reduce twice (n - 1) / n
    of its output (a reduce-scatter, then an all-gather), a permute its
    output.  The table's collective bytes count outputs, so one
    all-reduce of a tensor counts n times a reduce-scatter of it; wire
    bytes count both alike (`scripts/ref_dryrun_attribute.py`,
    `scripts/torch_dryrun_attribute.py`)."""
    if n <= 1:
        return 0.0
    return out_bytes * {"all-gather": (n - 1) / n, "all-to-all": (n - 1) / n,
                        "reduce-scatter": n - 1,
                        "all-reduce": 2 * (n - 1) / n}.get(kind, 1.0)


def _rows(path: str) -> dict:
    """{(mesh, arch, shape): row}; a skipped row that names no mesh (the
    reference's: a skip depends on the cell alone) stands for both."""
    with open(path) as f:
        rows = json.load(f)
    return {(m, r["arch"], r["shape"]): r for r in rows
            for m in ((r["mesh"],) if "mesh" in r else MESHES)}


def ratios(port: dict, ref: dict) -> dict:
    """{cell: {term: port / reference}} over the cells both ran ok."""
    out = {}
    for key, r in port.items():
        q = ref.get(key)
        if r["status"] != "ok" or q is None or q["status"] != "ok":
            continue
        out[key] = {name: r[sec][k] / q[sec][k] if q[sec][k] else None
                    for name, sec, k in TERMS}
    return out


def _fmt(x) -> str:
    return "-" if x is None else f"{x:.3g}"


def _terms(now: dict, old: dict) -> str:
    """"F / H / C / T" ratios of one cell, each moved by more than 10 %
    since `old` shown as "before → now"."""
    out = []
    for name in (t[0] for t in TERMS):
        x, was = now.get(name), old.get(name)
        moved = x is not None and was is not None and (
            abs(x - was) > 0.1 * abs(was))
        out.append(f"{_fmt(was)} → {_fmt(x)}" if moved else _fmt(x))
    return " / ".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("port")
    ap.add_argument("ref")
    ap.add_argument("--before", default=None,
                    help="an older port table, its ratios shown beside")
    args = ap.parse_args(argv)
    port, ref = _rows(args.port), _rows(args.ref)
    now = ratios(port, ref)
    old = ratios(_rows(args.before), ref) if args.before else {}
    print("| arch | shape | " + " | ".join(
        f"{m}: FLOPs / HBM / coll / temp" for m in MESHES) + " |")
    print("|" + " --- |" * (2 + len(MESHES)))
    both_skip = []
    for arch, shape in sorted({k[1:] for k in set(port) | set(ref)}):
        if all(t.get((m, arch, shape), {}).get("status") == "skipped"
               for t in (port, ref) for m in MESHES):
            both_skip.append(f"{arch} {shape}")
            continue
        cells = []
        for m in MESHES:
            key = (m, arch, shape)
            if key in now:
                cells.append(_terms(now[key], old.get(key, {})))
            else:
                cells.append(port.get(key, {}).get("status", "-") + " / "
                             + ref.get(key, {}).get("status", "-"))
        print(f"| {arch} | {shape} | " + " | ".join(cells) + " |")
    print(f"\nskipped by both on both meshes: {', '.join(both_skip)}")
    print("\noutside 0.5-2x (FLOPs, coll, temp):")
    for key, r in sorted(now.items()):
        bad = {n: r[n] for n in ("FLOPs", "coll", "temp")
               if r[n] is not None and not BAND[0] <= r[n] <= BAND[1]}
        if bad:
            print("  " + " ".join(key) + ": "
                  + ", ".join(f"{n} {v:.3g}" for n, v in bad.items()))


if __name__ == "__main__":
    main()
