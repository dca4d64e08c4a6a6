"""The port's dry run (`launch/dryrun.py`) and perf harness
(`launch/perf.py`), each cell in a subprocess on a fake 256- or 512-rank
world, on the CPU.

* whisper-tiny decode_32k on (16, 16) and granite-3-2b decode_32k on
  (2, 16, 16) are `ok`, with traced FLOPs > 0 and the bottleneck named;
  yi-9b long_500k is `skipped` (full attention), as in the reference;
* the argument bytes of granite-3-2b train_4k on (16, 16) equal one
  device's shards of the parameters, the two AdamW moments and the batch,
  computed by hand from `spec_for`;
* a perf variant the port does not act on (`remat_dots` on a dense
  cell: its only field is the remat policy) says so in its note and
  traces the baseline's numbers.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.distributed import sharding as TSH
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
MESH = {"16x16": {"data": 16, "model": 16},
        "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _run(module: str, args: list, tmp_path: Path, out_flag="--out"):
    out = tmp_path / "out.json"
    proc = subprocess.run(
        [sys.executable, "-m", module, *args, out_flag, str(out)],
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="2"))
    return proc, (json.loads(out.read_text()) if out.exists() else None)


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("whisper-tiny", "decode_32k", False),
    ("granite-3-2b", "decode_32k", True)])
def test_dryrun_cell_is_ok(tmp_path, arch, shape, multi_pod):
    args = ["--arch", arch, "--shape", shape]
    proc, rows = _run("repro_torch.launch.dryrun",
                      args + (["--multi-pod"] if multi_pod else []), tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (row,) = rows
    assert row["status"] == "ok" and row["mesh"] == (
        "2x16x16" if multi_pod else "16x16")
    r = row["roofline"]
    assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert row["memory"]["argument_bytes"] > 0
    assert row["memory"]["peak_bytes"] == (row["memory"]["argument_bytes"]
                                           + row["memory"]["temp_bytes"])
    assert "1 ok, 0 skipped (documented), 0 FAILED" in proc.stdout


def test_long_context_cell_of_a_full_attention_arch_is_skipped(tmp_path):
    proc, rows = _run("repro_torch.launch.dryrun",
                      ["--arch", "yi-9b", "--shape", "long_500k"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert rows[0]["status"] == "skipped"
    assert "sub-quadratic" in rows[0]["reason"]


def test_train_cell_argument_bytes_are_the_local_shards(tmp_path):
    """params (bf16) + the two f32 moments + tokens / labels (int32), each
    one device's shard under its `spec_for` on (16, 16)."""
    arch, shape = "granite-3-2b", "train_4k"
    proc, rows = _run("repro_torch.launch.dryrun",
                      ["--arch", arch, "--shape", shape], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    cfg = TR.get_arch(arch)
    mesh = MESH["16x16"]
    want = 0
    specs = TT.param_specs(cfg)
    for name, (shp, dtype) in TT.param_shapes(cfg).items():
        spec = TSH.spec_for(shp, specs[name], mesh)
        local = math.prod(TSH.local_shape(shp, spec, mesh))
        want += local * (torch.empty((), dtype=dtype).element_size() + 8)
    for t in TR.input_specs(cfg, TR.get_shape(shape)).values():
        spec = TSH.spec_for((t.shape[0],), ("batch",), mesh)
        want += math.prod(TSH.local_shape(
            tuple(t.shape), (spec[0], None), mesh)) * t.element_size()
    assert rows[0]["memory"]["argument_bytes"] == want


def test_perf_variant_the_port_ignores_says_so(tmp_path):
    proc, rows = _run("repro_torch.launch.perf",
                      ["--arch", "whisper-tiny", "--shape", "decode_32k",
                       "--variants", "baseline,remat_dots"], tmp_path,
                      out_flag="--json")
    assert proc.returncode == 0, proc.stderr[-3000:]
    base, remat = rows
    assert "note" not in base and "remat_policy" in remat["note"]
    for key in ("hlo_flops", "hlo_bytes", "coll_bytes"):
        assert remat[key] == base[key], key
