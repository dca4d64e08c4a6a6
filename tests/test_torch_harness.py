"""Shared helpers of the port's tests (tests/test_torch_*.py), plus the
tests of the port's device policy, which need no reference.

* `port_from_reference`: a JAX `repro` simulator -> numpy -> the port's
  `repro_torch.convert` -> a port `ChipSimulator` computing the same
  network (same quantized tensors, mapping and register tables);
* `assert_step_close`: the teacher-forced layer-step comparator — the
  same inputs and state through a reference step and a port step;
* `tie_free_trains`: a search for input trains on which no touched
  neuron comes within `margin` of the threshold, so whole runs can be
  held to equal spikes although the two frameworks round differently;
* `c_argtypes` / `launch_args`: a CUDA source's C launch signature as
  ctypes types, and the arguments a kernel wrapper passes to its launch,
  so the CPU tests hold the binding to the source.

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

V_ATOL = V_RTOL = 1e-5
TIE = 1e-4


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


def port_from_reference(ref_sim, engine: str = "fused", device="cpu"):
    """A port ChipSimulator of the same network as `ref_sim`."""
    from repro_torch import ChipSimulator, convert

    conv = convert(**reference_arrays(ref_sim), device=device)
    return ChipSimulator(conv.weights, mapping=conv.mapping,
                         register_tables=conv.register_tables,
                         quant_cfg=ref_sim.quant_cfg if ref_sim.qweights
                         is not None else None,
                         freq_hz=ref_sim.freq_hz,
                         zero_skip=ref_sim.zero_skip,
                         partial_update=ref_sim.partial_update,
                         leak=ref_sim.lif.leak,
                         threshold=ref_sim.lif.threshold,
                         engine=engine, device=device)


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


def min_tie_margin(weights, lif, trains) -> float:
    """Smallest |v_int - θ| over touched neurons of a dense run (port
    compiled-engine math on the CPU) — the fixture's distance from a
    spike that rounding could flip."""
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
    return margin


def tie_free_trains(weights, lif, shape, density=0.25, margin=1e-5,
                    tries=50):
    """Bernoulli(density) trains of `shape` (seeds 0, 1, ...) whose run
    stays at least `margin` from the threshold on every touched neuron."""
    for seed in range(tries):
        rng = np.random.default_rng(1000 + seed)
        trains = (rng.random(shape) < density).astype(np.float32)
        if min_tie_margin(weights, lif, trains) > margin:
            return trains
    raise RuntimeError("no tie-free fixture found")


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
