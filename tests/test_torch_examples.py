"""The port's examples on the CPU at small arguments: examples/
torch_quickstart.py (each contribution against the reference's function
on the same inputs) and examples/torch_snn_nmnist_e2e.py (train,
quantize, compile and simulate on the compiled engine, with its own
differential check against the interpretive reference engine)."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_reference(capsys):
    """The codebook fit's error, the zero-skip product (f64 sums against
    the reference's f32: within 1e-6) and its skip counters, the LIF step
    on the port's own current bitwise, the NoC and energy numbers."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    import repro.core as C
    from repro.kernels import ops as RO

    out = _example("torch_quickstart").main(["--device", "cpu"])
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(0, 0.02, (512, 256)), jnp.float32)
    q = C.quantize(w, C.CodebookConfig(n_levels=16, bit_width=8))
    rel = float(jnp.sqrt(jnp.mean((C.dequantize(q) - w) ** 2)) / w.std())
    assert abs(out["quant_rel_err"] - rel) <= 1e-5
    spikes = jnp.asarray(rng.random((128, 512)) < 0.05, jnp.float32)
    want, skipped = RO.zspe_spmm(spikes, C.dequantize(q), with_stats=True)
    np.testing.assert_allclose(out["zspe_out"].numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out["skipped"].numpy(), np.asarray(skipped))
    lif = RO.lif_update(jnp.zeros((128, 256)), jnp.zeros((128, 256),
                                                         jnp.int32),
                        jnp.asarray(out["zspe_out"].numpy()))
    for got, ref in zip(out["lif"], lif):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert dataclasses.asdict(out["noc"]) == dataclasses.asdict(
        C.fullerene_metrics())
    rep = C.simulate_traffic(C.fullerene_adjacency(),
                             [(12, [20, 25, 30], 64), (15, [31], 64)])
    assert out["traffic"].spikes_delivered == rep.spikes_delivered
    assert out["traffic"].mode_counts == rep.mode_counts
    assert out["traffic"].pj_per_spike_hop == rep.pj_per_spike_hop
    assert out["chip_pj_per_sop_90"] == C.calibrate_chip(
        C.calibrate_core()).chip_pj_per_sop(0.9)
    text = capsys.readouterr().out
    assert text.count("[C") == 5 and "[E]" in text


def test_snn_nmnist_e2e_runs_on_cpu(capsys):
    out = _example("torch_snn_nmnist_e2e").main(
        ["--device", "cpu", "--steps", "3", "--timesteps", "4"])
    assert 0.0 <= out["acc_fp"] <= 1.0 and 0.0 <= out["acc_q"] <= 1.0
    assert tuple(out["counts"].shape) == (8, 10)
    assert np.array_equal(out["counts"][0].numpy(), out["ref_counts"].numpy())
    assert out["compiled"].summary()["layers"] == 2
    assert np.isfinite(out["report"].pj_per_sop) and \
        out["report"].pj_per_sop > 0
    text = capsys.readouterr().out
    assert "differential check vs interpretive reference: spikes " \
           "identical" in text
