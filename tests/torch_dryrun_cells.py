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


def cells(jobs: dict, tmp: Path, timeout: float = 900) -> dict:
    """jobs {name: (package, arch, shape, multi_pod)}, `package`
    "repro_torch" or "repro" -> {name: row}; fails unless every process
    exits 0 with one row of status "ok"."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")
    procs = {}
    for name, (package, arch, shape, multi_pod) in jobs.items():
        out = tmp / f"{name}.json"
        cmd = [sys.executable, "-m", f"{package}.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out)]
        procs[name] = (out, subprocess.Popen(
            cmd + (["--multi-pod"] if multi_pod else []), env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
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
