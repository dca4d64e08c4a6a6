"""The port's dry run (`launch/dryrun.py`) and perf harness
(`launch/perf.py`), each cell in a subprocess on a fake 256- or 512-rank
world, on the CPU.

* whisper-tiny decode_32k on (16, 16) and granite-3-2b decode_32k on
  (2, 16, 16) are `ok`, with traced FLOPs > 0 and the bottleneck named;
  yi-9b long_500k is `skipped` (full attention), as in the reference;
* the argument bytes of granite-3-2b train_4k on (16, 16) equal one
  device's shards of the parameters, the two AdamW moments and the batch,
  computed by hand from `spec_for`; its temp bytes (the blocks
  rematerialised, the loss on each device's rows) lie within 0.5-2x of
  the reference's `repro.launch.dryrun` row, run beside it, and with
  the argument bytes below an H100's 80 GB (the port's cell is traced
  once for both tests);
* the perf variant `remat_dots` traces a decode cell's baseline numbers
  (no backward to rematerialise); on a train cell (one device, in this
  process) it lowers the FLOPs and raises the temp bytes.
"""
import dataclasses
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


TRAIN_CELL = ("granite-3-2b", "train_4k")
H100_BYTES = 80e9


@pytest.fixture(scope="module")
def train_cell(tmp_path_factory):
    """The port's dry-run row of granite-3-2b train_4k on (16, 16)."""
    arch, shape = TRAIN_CELL
    proc, rows = _run("repro_torch.launch.dryrun",
                      ["--arch", arch, "--shape", shape],
                      tmp_path_factory.mktemp("cell"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return rows[0]


def test_train_cell_argument_bytes_are_the_local_shards(train_cell):
    """params (bf16) + the two f32 moments + tokens / labels (int32), each
    one device's shard under its `spec_for` on (16, 16)."""
    arch, shape = TRAIN_CELL
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
    assert train_cell["memory"]["argument_bytes"] == want


def test_train_cell_temp_bytes_are_the_references(train_cell, tmp_path):
    """The reference's temp bytes of the cell (XLA's buffer assignment,
    its blocks under `jax.checkpoint`) against the port's (the peak of
    the traced step's live storages): within 0.5-2x, and the port's
    argument plus temp bytes fit one H100."""
    pytest.importorskip("jax")
    arch, shape = TRAIN_CELL
    out = tmp_path / "ref.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    (ref,) = json.loads(out.read_text())
    got = train_cell["memory"]
    ratio = got["temp_bytes"] / ref["memory"]["temp_bytes"]
    assert 0.5 <= ratio <= 2.0, (got, ref["memory"])
    assert got["argument_bytes"] + got["temp_bytes"] < H100_BYTES, got


def test_perf_variant_the_port_ignores_says_so(tmp_path):
    """`remat_dots` on a decode cell, which runs no backward to
    rematerialise: the baseline's numbers, and no note (the port acts on
    the variant, so it no longer says it ignores it; the train cell is
    `test_remat_dots_acts_on_train_cells`)."""
    proc, rows = _run("repro_torch.launch.perf",
                      ["--arch", "whisper-tiny", "--shape", "decode_32k",
                       "--variants", "baseline,remat_dots"], tmp_path,
                      out_flag="--json")
    assert proc.returncode == 0, proc.stderr[-3000:]
    base, remat = rows
    assert "note" not in base and "note" not in remat
    for key in ("hlo_flops", "hlo_bytes", "coll_bytes", "temp_gib"):
        assert remat[key] == base[key], key


def test_remat_dots_acts_on_train_cells():
    """`perf.apply_variant`'s `remat_dots` config against the baseline's
    (remat "nothing"), each traced (`trace_analysis.trace`) over one
    `make_train_step` step of granite-3-2b SMOKE at 2 layers, B 2 x S 256
    on one device: the variant recomputes only the batched products
    (fewer FLOPs) and keeps the 2-D products (more temp bytes)."""
    from repro_torch.distributed import trace_analysis as TTA
    from repro_torch.launch import perf as TP
    from repro_torch.launch import steps as TST
    from repro_torch.optim import adamw as TA

    cfg = dataclasses.replace(TR.get_arch("granite-3-2b", smoke=True),
                              n_layers=2, dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab, (2, 257),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    costs = {}
    for variant in ("baseline", "remat_dots"):
        vcfg, opts = TP.apply_variant(cfg, variant)
        assert not opts
        model = TT.init_model(vcfg, torch.Generator().manual_seed(0))
        opt = TA.init(dict(model.named_parameters()))
        step = TST.make_train_step(vcfg, TA.AdamWConfig(total_steps=10))
        costs[variant] = TTA.trace(lambda: step(model, opt, batch))
    assert cfg.remat_policy == "nothing"
    assert costs["remat_dots"].flops < costs["baseline"].flops
    assert costs["remat_dots"].temp_bytes > costs["baseline"].temp_bytes
