"""The port's copies of the numpy host modules (core/noc.py, core/energy.py,
compiler/) give the reference's outputs exactly: mappings of the paper's
networks, per-flow NoC tables and the batched energy pricing."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import snn_chip as REF_CFG  # noqa: E402
from repro.core import energy as REF_E  # noqa: E402
from repro.core import soc as REF_SOC  # noqa: E402
from repro.core.engine import lower_tables as ref_lower_tables  # noqa: E402

from repro_torch.configs import snn_chip as CFG  # noqa: E402
from repro_torch.core import energy as E  # noqa: E402
from repro_torch.core import soc as SOC  # noqa: E402
from repro_torch.core.engine import lower_tables  # noqa: E402


def _rows(mapping):
    return [dataclasses.astuple(a) for a in mapping.assignments]


def test_configs_are_copies():
    assert CFG.ARCH.layer_sizes == REF_CFG.ARCH.layer_sizes == (2312, 4096,
                                                                1024, 10)
    assert dataclasses.asdict(CFG.ARCH) == dataclasses.asdict(REF_CFG.ARCH)
    assert dataclasses.asdict(CFG.SMOKE) == dataclasses.asdict(REF_CFG.SMOKE)


@pytest.mark.parametrize("cfg", ["SMOKE", "ARCH"])
@pytest.mark.parametrize("strategy", ["anneal", "greedy"])
def test_map_network_equal(cfg, strategy):
    sizes = getattr(CFG, cfg).layer_sizes
    got = SOC.map_network(sizes, strategy=strategy)
    want = REF_SOC.map_network(sizes, strategy=strategy)
    assert _rows(got) == _rows(want)
    assert got.layer_sizes == want.layer_sizes


def test_compile_network_multi_domain_summary_equal():
    from repro import compiler as REF_CC

    from repro_torch import compiler as CC

    sizes = (256, 8192 * 12, 8192 * 12, 10)
    spec = CC.ChipSpec(max_domains=2)
    got = CC.compile_network(sizes, spec, anneal_iters=200)
    want = REF_CC.compile_network(sizes, REF_CC.ChipSpec(max_domains=2),
                                  anneal_iters=200)
    assert got.summary() == want.summary()
    assert _rows(got.to_soc_mapping()) == _rows(want.to_soc_mapping())


def _sim_pair(sizes, mapping=None):
    rng = np.random.default_rng(0)
    ws = [rng.normal(0, 0.5, (sizes[i], sizes[i + 1])).astype(np.float32)
          for i in range(len(sizes) - 1)]
    ref = REF_SOC.ChipSimulator([jax.numpy.asarray(w) for w in ws],
                                mapping=mapping)
    port = SOC.ChipSimulator(ws, mapping=SOC.Mapping(
        [SOC.CoreAssignment(*r) for r in _rows(ref.mapping)],
        list(ref.mapping.layer_sizes)), device="cpu")
    return ref, port


@pytest.mark.parametrize("multi_domain", [False, True],
                         ids=["one_domain", "two_domains"])
def test_flow_tables_equal(multi_domain):
    sizes = (64, 512, 512, 10) if multi_domain else (64, 128, 96, 10)
    mapping = None
    if multi_domain:
        from repro import compiler as REF_CC

        # 32-neuron cores: 33 core groups span two level-1 domains
        mapping = REF_CC.compile_network(
            sizes, REF_CC.ChipSpec(neurons_per_core=32, max_domains=2),
            anneal_iters=200).to_soc_mapping()
    ref, port = _sim_pair(sizes, mapping)
    assert (port.interconnect is None) == (not multi_domain)
    got, want = lower_tables(port), ref_lower_tables(ref)
    assert got.n_active_cores == want.n_active_cores
    assert got.nominal_sops_per_step == want.nominal_sops_per_step
    for lg, lw in zip(got.layers, want.layers):
        for f in ("slice_sizes", "core_index", "slice_onehot"):
            np.testing.assert_array_equal(getattr(lg, f), getattr(lw, f))
    for fg, fw in zip(got.flows, want.flows):
        assert (fg is None) == (fw is None)
        if fg is None:
            continue
        for f in ("hops", "energy_pj", "router_load", "dst_fanout",
                  "src_core"):
            np.testing.assert_array_equal(getattr(fg, f), getattr(fw, f))


def test_price_batched_equal():
    rng = np.random.default_rng(3)
    B = 7
    args = dict(nominal_sops=np.full(B, 1e6),
                performed_sops=rng.uniform(0, 1e6, B),
                noc_energy_pj=rng.uniform(0, 50, B),
                wall_cycles=rng.uniform(1e3, 1e5, B), steps=20,
                freq_hz=100e6)
    for zero_skip in (True, False):
        for partial in (True, False):
            got = E.price_batched(E.calibrate_core(), E.RiscvPowerModel(),
                                  zero_skip=zero_skip,
                                  partial_update=partial,
                                  weight_writes=np.zeros(B),
                                  write_model=E.WeightWriteModel(), **args)
            want = REF_E.price_batched(
                REF_E.calibrate_core(), REF_E.RiscvPowerModel(),
                zero_skip=zero_skip, partial_update=partial,
                weight_writes=np.zeros(B),
                write_model=REF_E.WeightWriteModel(), **args)
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_measure_spike_rates_match():
    from repro import compiler as REF_CC

    from repro_torch import compiler as CC

    rng = np.random.default_rng(5)
    ws = [rng.normal(0, 0.5, (48, 64)).astype(np.float32),
          rng.normal(0, 0.5, (64, 16)).astype(np.float32)]
    train = (rng.random((6, 48)) < 0.3).astype(np.float32)
    got = CC.measure_spike_rates(ws, train, device="cpu")
    want = REF_CC.measure_spike_rates([jax.numpy.asarray(w) for w in ws],
                                      train)
    assert got == want


def test_measure_spike_rates_defaults_to_the_card():
    from repro_torch import compiler as CC

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    ws = [np.ones((4, 3), np.float32)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CC.measure_spike_rates(ws, np.ones((2, 4), np.float32))
    # tensors stay on the device they lie on
    got = CC.measure_spike_rates([torch.ones(4, 3)], np.ones((2, 4)))
    assert got == CC.measure_spike_rates(ws, np.ones((2, 4)), device="cpu")
