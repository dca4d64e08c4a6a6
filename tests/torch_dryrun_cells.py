"""Dry-run cells of the port (`repro_torch.launch.dryrun`) and of the
reference (`repro.launch.dryrun`, its XLA on the CPU), each in a
subprocess of its own, all started at once: their JSON rows."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# a cell at a cut depth: the dry run imported first (the reference's
# sets its device count before JAX loads), then the package's `get_arch`
# returns the config with `n_layers` replaced and its own `main` runs
_CUT = """import dataclasses, sys
from {package}.launch import dryrun
from {package}.configs import registry as R
get = R.get_arch
R.get_arch = lambda name, smoke=False: dataclasses.replace(
    get(name, smoke), n_layers={layers})
sys.argv = sys.argv[:1] + {argv!r}
dryrun.main()
"""


def cells(jobs: dict, tmp: Path, timeout: float = 900) -> dict:
    """jobs {name: (package, arch, shape, multi_pod[, layers])},
    `package` "repro_torch" or "repro", `layers` a cut depth -> {name:
    row}; fails unless every process exits 0 with one row of status
    "ok"."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")
    procs = {}
    for name, (package, arch, shape, multi_pod, *cut) in jobs.items():
        out = tmp / f"{name}.json"
        argv = ["--arch", arch, "--shape", shape, "--out", str(out)] + (
            ["--multi-pod"] if multi_pod else [])
        cmd = [sys.executable, "-m", f"{package}.launch.dryrun", *argv]
        if cut:
            cmd = [sys.executable, "-c", _CUT.format(
                package=package, layers=cut[0], argv=argv)]
        procs[name] = (out, subprocess.Popen(
            cmd, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True))
    rows = {}
    try:
        for name, (out, proc) in procs.items():
            _, err = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, (name, err[-3000:])
            (rows[name],) = json.loads(out.read_text())
            assert rows[name]["status"] == "ok", rows[name]
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rows
