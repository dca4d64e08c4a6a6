"""Shared helpers of the port's tests (tests/test_torch_*.py), plus the
tests of the port's device policy, which need no reference.

* `port_from_reference`: a JAX `repro` simulator -> numpy -> the port's
  `repro_torch.convert` -> a port `ChipSimulator` computing the same
  network (same quantized tensors, mapping and register tables), under
  the same faults, trace and plasticity config when asked — built from
  the pre-fault network, since a faulted reference holds post-fault state;
  `port_spec` / `port_from_spec` split it at the plain data, which a
  spawned process that imports no JAX can receive;
* `assert_step_close`: the teacher-forced layer-step comparator — the
  same inputs and state through a reference step and a port step;
* `tie_free_trains`: a search for input trains on which no touched
  neuron comes within `margin` of the threshold, so whole runs can be
  held to equal spikes although the two frameworks round differently;
* `run_raw_ops`: the aten ops one engine run issues, in order, so a
  test can hold an option that is off to costing nothing;
* `c_argtypes` / `launch_args`: a CUDA source's C launch signature as
  ctypes types, and the arguments a kernel wrapper passes to its launch,
  so the CPU tests hold the binding to the source;
* `plastic_*`: the plasticity tests' network, trains, faults and runs
  (tests/test_torch_plasticity.py and test_torch_plasticity_runs.py).

The contract (ROADMAP.md): integers exact; v within V_ATOL + V_RTOL·|v|;
spikes equal except where the reference's |v_int - θ| < TIE.
"""
from __future__ import annotations

import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

V_ATOL = V_RTOL = 1e-5
TIE = 1e-4
REPORT_REL = 1e-6
STAT_FIELDS = ("nominal_sops", "performed_sops", "spikes_in",
               "spikes_routed", "neurons_touched", "noc_hops",
               "noc_energy_pj", "noc_contention_cycles")
REPORT_FIELDS = ("energy_pj", "core_energy_pj", "noc_energy_pj",
                 "riscv_energy_pj", "wall_cycles")


# ---------------------------------------------------------------------------
# reference -> port
# ---------------------------------------------------------------------------

def reference_arrays(ref_sim) -> dict:
    """The reference simulator's network as plain numpy / tuples."""
    if ref_sim.qweights is not None:
        layers = [dict(idx=np.asarray(q.idx), codebook=np.asarray(q.codebook),
                       scale=np.asarray(q.scale),
                       group_axis_size=int(q.group_axis_size))
                  for q in ref_sim.qweights]
    else:
        layers = [np.asarray(w, np.float32) for w in ref_sim.weights]
    return dict(
        layers=layers,
        mapping=[(a.core_id, a.layer, a.neuron_lo, a.neuron_hi)
                 for a in ref_sim.mapping.assignments],
        register_tables=[dataclasses.asdict(rt)
                         for rt in ref_sim.register_tables])


def port_spec(ref_sim, *, faulted: bool = False, weights=None) -> dict:
    """The reference simulator's network and settings as plain data
    (numpy, tuples, the port's CodebookConfig): what `port_from_spec`
    builds the port from, picklable into a process that imports no JAX.

    A faulted reference's `weights` and `register_tables` are post-fault,
    and folding the faults in again would apply them twice (a bit-flip
    applied twice flips back).  So with `faulted` the spec holds the
    pre-fault network, for the port to fold the faults in itself: a
    quantized reference's QuantizedTensors (which faults leave alone),
    with the register tables the port programs from them, or for a float
    reference `weights`, the float matrices it was built from.
    """
    from repro_torch import CodebookConfig

    arrays = reference_arrays(ref_sim)
    if faulted:
        if ref_sim.qweights is None:
            if weights is None:
                raise ValueError(
                    "a faulted float reference holds post-fault weights: "
                    "pass the pre-fault `weights` it was built from")
            arrays["layers"] = [np.asarray(w, np.float32) for w in weights]
        arrays["register_tables"] = None
    return dict(arrays=arrays,
                quant_cfg=(CodebookConfig(**dataclasses.asdict(
                    ref_sim.quant_cfg)) if ref_sim.qweights is not None
                           else None),
                freq_hz=ref_sim.freq_hz, zero_skip=ref_sim.zero_skip,
                partial_update=ref_sim.partial_update,
                leak=ref_sim.lif.leak, threshold=ref_sim.lif.threshold)


def port_from_spec(spec: dict, engine: str = "fused", device="cpu", *,
                   faults=None, trace=None, plasticity=None):
    """A port ChipSimulator of a `port_spec`; `faults` / `trace` /
    `plasticity` are the port's FaultConfig / TraceConfig /
    PlasticityConfig."""
    from repro_torch import ChipSimulator, convert

    conv = convert(**spec["arrays"], device=device)
    return ChipSimulator(conv.weights, mapping=conv.mapping,
                         register_tables=conv.register_tables,
                         quant_cfg=spec["quant_cfg"],
                         freq_hz=spec["freq_hz"],
                         zero_skip=spec["zero_skip"],
                         partial_update=spec["partial_update"],
                         leak=spec["leak"], threshold=spec["threshold"],
                         engine=engine, faults=faults, trace=trace,
                         plasticity=plasticity, device=device)


def port_from_reference(ref_sim, engine: str = "fused", device="cpu", *,
                        faults=None, trace=None, plasticity=None,
                        weights=None):
    """A port ChipSimulator of the same network as `ref_sim`, under the
    port's `faults` / `trace` / `plasticity` configs, equal to the
    reference's (see `port_spec` for a faulted reference's `weights`)."""
    return port_from_spec(
        port_spec(ref_sim, faulted=faults is not None, weights=weights),
        engine, device, faults=faults, trace=trace, plasticity=plasticity)


# ---------------------------------------------------------------------------
# comparators
# ---------------------------------------------------------------------------

def assert_step_close(ref_out, port_out, v_int, touched=None):
    """Hold one port layer-step to the reference's outputs.

    `ref_out` / `port_out`: (v', elapsed', spikes, touched, nnz, empty)
    as numpy-convertible arrays; `v_int`: the reference's integrated
    potential (where it crosses θ = 1 decides the spike); `touched`
    restricts tie exemptions to touched neurons (partial update).
    """
    ref = [np.asarray(x) for x in ref_out]
    got = [np.asarray(x) for x in port_out]
    for i in (1, 3, 4, 5):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"output {i}")
    near = np.abs(np.asarray(v_int) - 1.0) < TIE
    if touched is not None:
        near &= np.asarray(touched) > 0
    flip = got[2] != ref[2]
    assert not (flip & ~near).any(), "spikes differ away from the threshold"
    keep = ~flip
    np.testing.assert_allclose(got[0][keep], ref[0][keep], rtol=V_RTOL,
                               atol=V_ATOL)


def assert_reports_close(got, want, rel=REPORT_REL):
    """Per-sample ChipReports: every stat and energy / wall field within
    `rel` relative (of max(|want|, 1))."""
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        for f in STAT_FIELDS:
            a, c = getattr(w.stats, f), getattr(g.stats, f)
            assert abs(a - c) <= rel * max(abs(a), 1.0), (b, f, a, c)
        for f in REPORT_FIELDS:
            a, c = getattr(w, f), getattr(g, f)
            assert abs(a - c) <= rel * max(abs(a), 1.0), (b, f, a, c)


def min_tie_margin(weights, lif, trains, drop=None) -> float:
    """Smallest |v_int - θ| over touched neurons of a dense run (port
    compiled-engine math on the CPU) — the fixture's distance from a
    spike that rounding could flip.  `drop`: per layer None or the
    (T, n_post) survival masks of a drop plan, applied to the layer's
    output spikes as the engines apply them."""
    from repro_torch.core.neuron import init_state, lif_step, touch_mask

    ws = [torch.tensor(np.asarray(w, np.float32)) for w in weights]
    trains = torch.tensor(np.asarray(trains, np.float32))
    B, T, _ = trains.shape
    states = [init_state(int(w.shape[1]), (B,), device="cpu") for w in ws]
    margin = np.inf
    for t in range(T):
        spikes = trains[:, t]
        for li, w in enumerate(ws):
            cur = spikes @ w
            tm = touch_mask(spikes, (w != 0).to(torch.float32))
            st = states[li]
            pending = st.elapsed + 1
            if lif.partial_update:
                v_int = st.v * lif.leak ** pending.float() + cur
                gap = (v_int - lif.threshold).abs()[tm]
            else:
                gap = (st.v * lif.leak + cur - lif.threshold).abs()
            if gap.numel():
                margin = min(margin, float(gap.min()))
            states[li], spikes, _ = lif_step(st, cur, lif, touched=tm)
            if drop is not None and drop[li] is not None:
                spikes = spikes * torch.as_tensor(drop[li][t])
    return margin


def tie_free_trains(weights, lif, shape, density=0.25, margin=1e-5,
                    tries=50, drop=None):
    """Bernoulli(density) trains of `shape` (seeds 0, 1, ...) whose run
    (under the drop masks `drop`, see `min_tie_margin`) stays at least
    `margin` from the threshold on every touched neuron."""
    for seed in range(tries):
        rng = np.random.default_rng(1000 + seed)
        trains = (rng.random(shape) < density).astype(np.float32)
        if min_tie_margin(weights, lif, trains, drop) > margin:
            return trains
    raise RuntimeError("no tie-free fixture found")


class _AtenOps(TorchDispatchMode):
    """The aten ops a block issues, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def run_raw_ops(sim, trains):
    """(aten op names, counters, counts) of one `run_raw` of the
    simulator's engine, built before the count starts."""
    eng = sim.array_engine()
    with _AtenOps() as mode:
        ys, counts = eng.run_raw(trains)
    return mode.ops, ys, counts


# ---------------------------------------------------------------------------
# plasticity fixtures (tests/test_torch_plasticity*.py): the reference
# suite's network and runs (tests/test_plasticity.py)
# ---------------------------------------------------------------------------

PLASTIC_SIZES = [64, 96, 96, 16]  # widths stay multiples of 16 (fused pack)
PLASTIC_STDP = dict(enabled=True, mode="stdp", lr=0.4)
PLASTIC_REWARD = dict(enabled=True, mode="reward", lr=0.4, elig_pre=0.1,
                      layers=(2,))
PLASTIC_RULES = {"stdp": PLASTIC_STDP, "reward": PLASTIC_REWARD}
PLASTIC_ENGINES = ("compiled", "fused", "reference")
PLASTIC_REPORT_FIELDS = REPORT_FIELDS + ("write_energy_pj",)
PLASTIC_CB_FAULT = (("stuck", 12, 0, 0, 3), ("bitflip", 13, 2, 5, 0))


def plastic_weights(sizes=PLASTIC_SIZES, seed=0):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.normal(0, 1.2 / np.sqrt(a), (a, b)), np.float32)
            for a, b in zip(sizes[:-1], sizes[1:])]


def plastic_trains(batch=4, T=6, seed=1):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.random((batch, T, PLASTIC_SIZES[0])) < 0.25,
                      np.float32)


def plastic_faults(port: bool):
    """The two codebook faults, as the port's or the reference's config."""
    if port:
        from repro_torch.faults import CodebookFault, FaultConfig
    else:
        from repro.faults import CodebookFault, FaultConfig
    return FaultConfig(codebook_faults=tuple(
        CodebookFault(kind=k, core_id=c, word=w, bit=b, value=v)
        for k, c, w, b, v in PLASTIC_CB_FAULT))


def plastic_pair(rule, engine="compiled", faulted=False):
    """(reference simulator, the port's of the same network)."""
    from repro.core import plasticity as ref_plasticity
    from repro.core.quant import CodebookConfig as RefCodebookConfig
    from repro.core.soc import ChipSimulator as RefChipSimulator

    from repro_torch import PlasticityConfig

    ref = RefChipSimulator(
        plastic_weights(), engine=engine, quant_cfg=RefCodebookConfig(8, 8),
        plasticity=ref_plasticity.PlasticityConfig(**PLASTIC_RULES[rule]),
        faults=plastic_faults(False) if faulted else None)
    port = port_from_reference(
        ref, engine=engine,
        plasticity=PlasticityConfig(**PLASTIC_RULES[rule]),
        faults=plastic_faults(True) if faulted else None)
    return ref, port


def plastic_port_sim(engine, rule=None, mapping=None, **kw):
    from repro_torch import ChipSimulator, CodebookConfig, PlasticityConfig

    return ChipSimulator(plastic_weights(), engine=engine, device="cpu",
                         quant_cfg=CodebookConfig(8, 8), mapping=mapping,
                         plasticity=None if rule is None
                         else PlasticityConfig(**PLASTIC_RULES[rule]), **kw)


def to_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_learned_equal(got, want, msg=""):
    assert len(got) == len(want), msg
    for g, w in zip(got, want):
        assert (g is None) == (w is None), msg
        if w is not None:
            np.testing.assert_array_equal(to_np(g), to_np(w), err_msg=msg)


def assert_plastic_runs_equal(got, want, msg=""):
    """Two (counts, reports, learned) runs: spikes, learned indexes and
    writes equal, report fields within 1e-6."""
    (c_g, r_g, l_g), (c_w, r_w, l_w) = got, want
    np.testing.assert_array_equal(to_np(c_g), to_np(c_w), err_msg=msg)
    assert_learned_equal(l_g, l_w, msg)
    for a, b in zip(r_g, r_w):
        assert a.stats.weight_writes == b.stats.weight_writes, msg
        for f in PLASTIC_REPORT_FIELDS:
            va, vb = getattr(a, f), getattr(b, f)
            assert abs(va - vb) <= 1e-6 * max(abs(vb), 1.0), (msg, f, va, vb)


def plastic_run(sim, trains, learned=None):
    """(counts, reports, last_learned) of one run of either package's
    simulator (the reference's takes a jax array)."""
    from repro_torch import ChipSimulator

    if not isinstance(sim, ChipSimulator):
        import jax.numpy as jnp
        trains = jnp.asarray(trains)
    counts, reports = sim.run_batch(trains, learned=learned)
    return counts, reports, sim.last_learned

# ---------------------------------------------------------------------------
# device policy (no reference needed)
# ---------------------------------------------------------------------------

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")


def c_argtypes(source: str, fn: str) -> list:
    """The ctypes types of `int fn(...)` in `csrc/<source>.cu`."""
    text = (CSRC / f"{source}.cu").read_text()
    params = re.search(rf"int {fn}\(([^)]*)\)", text).group(1)
    types = []
    for param in params.split(","):
        words = " ".join(param.split()).rsplit(" ", 1)[0]
        types.append(_C_TYPES[words.replace(" *", "*")])
    return types


def launch_args(monkeypatch, module, call) -> list:
    """Run `call()` as if its tensors lay on a card: the module's operand
    check answers "cuda" and its `launch` records (fn, argtypes, args)
    instead of calling the library.  Tensors stay on the CPU."""
    calls = []
    monkeypatch.setattr(module, "check_operands",
                        lambda *a, **k: torch.device("cuda"))
    monkeypatch.setattr(module, "launch",
                        lambda lib, fn, argtypes, *args:
                        calls.append((fn, argtypes, args)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: type("S", (), {"cuda_stream": 0}))
    call()
    return calls


def test_default_device_raises_without_card():
    from repro_torch import ChipSimulator, quantize, resolve_device
    from repro_torch.core.quant import CodebookConfig

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    w = np.random.default_rng(0).normal(0, 0.5, (32, 16)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChipSimulator([w])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quantize(w, CodebookConfig())
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_on_request_and_tf32_off():
    import repro_torch
    from repro_torch import ChipSimulator

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    w = np.random.default_rng(0).normal(0, 0.5, (32, 16)).astype(np.float32)
    sim = ChipSimulator([w], device="cpu")
    assert sim.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in sim.weights)
    assert callable(repro_torch.convert)
