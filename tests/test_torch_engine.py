"""The port's main path, `ChipSimulator(engine="fused").run_batch`, on the
CPU: against the reference's fused engine on a tie-free fixture (spikes
and integer counters equal, ChipReport fields within 1e-6 relative), and
bit-exact against the port's own compiled engine at word-aligned widths."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs.snn_chip import SMOKE  # noqa: E402
from repro.core.quant import CodebookConfig as RefCodebookConfig  # noqa: E402
from repro.core.soc import ChipSimulator as RefChipSimulator  # noqa: E402
from test_torch_harness import (assert_reports_close,  # noqa: E402
                                port_from_reference, tie_free_trains)

from repro_torch import ChipSimulator, CodebookConfig  # noqa: E402
from repro_torch.kernels import fused_timestep as FT  # noqa: E402


def _weights(sizes, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, scale, (sizes[i], sizes[i + 1])).astype(np.float32)
            for i in range(len(sizes) - 1)]


@pytest.mark.parametrize("quantized", [True, False],
                         ids=["quantized", "float"])
def test_smoke_run_batch_matches_reference(quantized):
    from repro.core.neuron import LIFParams

    sizes = SMOKE.layer_sizes
    ws = _weights(sizes)
    qcfg = (RefCodebookConfig(n_levels=SMOKE.weight_levels,
                              bit_width=SMOKE.weight_bits, zero_level=True)
            if quantized else None)
    ref = RefChipSimulator([jax.numpy.asarray(w) for w in ws],
                           quant_cfg=qcfg, engine="fused",
                           freq_hz=SMOKE.freq_hz)
    port = port_from_reference(ref, engine="fused")
    assert port.fused_engine().codebook_layers == (len(ws) if quantized
                                                   else 0)
    trains = tie_free_trains([np.asarray(w) for w in ref.weights],
                             LIFParams(), (3, SMOKE.timesteps, sizes[0]))
    ref_ys = ref.fused_engine().run_raw(jax.numpy.asarray(trains))
    ys, counts = port.fused_engine().run_raw(trains)
    assert set(ys) == set(ref_ys) - {"out"}
    for key in ys:
        np.testing.assert_array_equal(ys[key].numpy(),
                                      np.asarray(ref_ys[key]), err_msg=key)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(ref_ys["out"]).sum(axis=1))
    ref_counts, ref_reports = ref.run_batch(jax.numpy.asarray(trains))
    got_counts, got_reports = port.run_batch(trains)
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(ref_counts))
    assert_reports_close(got_reports, ref_reports)
    assert [r.stats.spike_words_skipped for r in got_reports] == \
        [r.stats.spike_words_skipped for r in ref_reports]


@pytest.mark.parametrize("quantized", [True, False],
                         ids=["quantized", "float"])
def test_fused_bit_exact_with_compiled(quantized):
    sizes = (64, 128, 32)
    ws = _weights(sizes, seed=3)
    qcfg = CodebookConfig(16, 8, zero_level=True) if quantized else None
    fused = ChipSimulator(ws, quant_cfg=qcfg, engine="fused", device="cpu")
    comp = ChipSimulator(ws, quant_cfg=qcfg, engine="compiled",
                         mapping=fused.mapping, device="cpu")
    trains = (np.random.default_rng(4).random((5, 6, sizes[0]))
              < 0.25).astype(np.float32)
    ys_f, c_f = fused.fused_engine().run_raw(trains)
    ys_c, c_c = comp.compiled_engine().run_raw(trains)
    assert torch.equal(c_f, c_c) and float(c_f.sum()) > 0
    for key in ys_c:
        assert torch.equal(ys_f[key], ys_c[key]), key
    _, rep_f = fused.run_batch(trains)
    _, rep_c = comp.run_batch(trains)
    assert_reports_close(rep_f, rep_c, rel=0.0)


def test_single_sample_run_and_cpu_launches_uncounted():
    sim = ChipSimulator(_weights((48, 64, 10)), quant_cfg=CodebookConfig(),
                        engine="fused", device="cpu")
    train = (np.random.default_rng(0).random((4, 48)) < 0.3).astype(
        np.float32)
    before = dict(FT.launches)
    counts, report = sim.run(train)
    batch_counts, reports = sim.run_batch(train[None])
    assert torch.equal(counts, batch_counts[0])
    assert report.energy_pj == reports[0].energy_pj
    assert FT.launches == before
    with pytest.raises(ValueError, match="batch, T, n_in"):
        sim.run_batch(train)


def test_sharded_engine_builds_and_runs_on_the_cpu():
    """Without a process group the sharded engine is one shard holding
    the whole matrix: the compiled engine's counts and reports."""
    ws = _weights((32, 48, 16))
    train = (np.random.default_rng(0).random((2, 5, 32)) < 0.3).astype(
        np.float32)
    sim = ChipSimulator(ws, engine="sharded", device="cpu")
    eng = sim.array_engine()
    assert eng is sim.sharded_engine() and eng.n_shards == 1
    counts, reports = sim.run_batch(train)
    want, want_reports = ChipSimulator(
        ws, engine="compiled", mapping=sim.mapping,
        device="cpu").run_batch(train)
    assert torch.equal(counts, want) and not eng.last_run_sharded
    assert [r.energy_pj for r in reports] == [r.energy_pj
                                              for r in want_reports]


def test_unknown_engine_and_index_weights_rejected():
    with pytest.raises(ValueError, match="engine must be"):
        ChipSimulator(_weights((32, 16)), engine="dense", device="cpu")
    with pytest.raises(TypeError, match="codebook indices"):
        ChipSimulator([np.ones((32, 16), np.int8)], device="cpu")
    idx_like = np.random.default_rng(0).integers(0, 16, (32, 16)).astype(
        np.float32)
    with pytest.raises(ValueError, match="look like codebook"):
        ChipSimulator([idx_like], quant_cfg=CodebookConfig(), device="cpu")


def _arch_quantized(sizes, seed=0):
    """Index weights of the layer sizes on a 16-level, 8-bit codebook
    (no fit: a grid of levels, random indexes)."""
    from repro.core.quant import QuantizedTensor

    rng = np.random.default_rng(seed)
    scale = np.float32(2.0 ** -7)
    cb = (np.arange(-8, 8, dtype=np.float32) * 3 + 1) * scale
    return [QuantizedTensor(
        idx=jax.numpy.asarray(rng.integers(0, 16, (sizes[i], sizes[i + 1]),
                                           dtype=np.int8)),
        codebook=jax.numpy.asarray(cb[None]),
        scale=jax.numpy.asarray([scale]), group_axis_size=0)
        for i in range(len(sizes) - 1)]


def test_hbm_bytes_per_step_matches_reference():
    """`FusedEngine.hbm_bytes_per_step` of the paper's network (ARCH,
    codebook form) and `FusedLayerWeights.hbm_bytes_per_step` of each of
    its layers and of a float network's (dense form)."""
    from repro.configs.snn_chip import ARCH

    ref = RefChipSimulator(_arch_quantized(ARCH.layer_sizes),
                           quant_cfg=RefCodebookConfig(16, 8),
                           engine="fused", mapping_strategy="greedy")
    port = port_from_reference(ref, engine="fused")
    want, got = ref.fused_engine(), port.fused_engine()
    assert got.codebook_layers == want.codebook_layers == 3
    ref_f = RefChipSimulator([jax.numpy.asarray(w) for w in _weights(
        SMOKE.layer_sizes)], engine="fused", freq_hz=SMOKE.freq_hz)
    port_f = port_from_reference(ref_f, engine="fused")
    assert port_f.fused_engine().codebook_layers == 0
    for batch in (1, 32):
        assert got.hbm_bytes_per_step(batch) == want.hbm_bytes_per_step(
            batch)
        for eng_ref, eng in ((want, got), (ref_f.fused_engine(),
                                           port_f.fused_engine())):
            assert [lw.hbm_bytes_per_step(batch) for lw in
                    eng.fused_weights] == [lw.hbm_bytes_per_step(batch)
                                           for lw in eng_ref.fused_weights]
