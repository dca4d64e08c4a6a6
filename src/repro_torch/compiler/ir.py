"""Compiler IR: the network description the mapping compiler consumes.

A `NetworkGraph` abstracts every supported frontend (dense SNN MLPs from
models/snn.py, conv SNNs from models/snn_conv.py, raw weight lists) into
the only facts the mapper needs: per-layer neuron counts, fan-in, and the
expected spike traffic each layer emits per timestep.  Spike rates can be
*measured* (by running the net on event data — see `measure_spike_rates`)
or *estimated* from the input stream's sparsity with a geometric
attenuation per layer, which is how real toolchains bootstrap placement
before profiling data exists.

`ChipSpec` is the hardware side: core count/capacity per level-1 domain,
how many domains the deployment may scale up to, and the router/energy
constants used to price routes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core import energy as E
from repro_torch.core import noc as NOC


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One mappable layer.  `index` 0 is the input population (never placed
    on a core); placed layers start at index 1."""

    index: int
    n_neurons: int
    fan_in: int
    kind: str = "dense"          # "input" | "dense" | "conv"
    name: str = ""

    def __post_init__(self):
        if self.n_neurons <= 0:
            raise ValueError(f"layer {self.index}: n_neurons must be > 0")


@dataclasses.dataclass(frozen=True)
class NetworkGraph:
    layers: tuple[LayerSpec, ...]
    spike_rates: tuple[float, ...]   # spikes/timestep emitted by each layer

    def __post_init__(self):
        if len(self.layers) < 2:
            raise ValueError("need an input layer and >= 1 placed layer")
        if len(self.spike_rates) != len(self.layers):
            raise ValueError("one spike rate per layer required")
        if self.layers[0].kind != "input":
            raise ValueError("layer 0 must be the input population")

    @property
    def placed_layers(self) -> tuple[LayerSpec, ...]:
        return self.layers[1:]

    @property
    def total_neurons(self) -> int:
        return sum(l.n_neurons for l in self.placed_layers)

    def layer_sizes(self) -> tuple[int, ...]:
        return tuple(l.n_neurons for l in self.layers)


# Default traffic estimate: event inputs fire at ~10% (the NMNIST regime);
# each LIF stage attenuates traffic — deep layers both shrink and sparsify.
DEFAULT_INPUT_RATE = 0.10
DEFAULT_LAYER_FIRING = 0.08


def estimate_spike_rates(layer_sizes: Sequence[int],
                         input_rate: float = DEFAULT_INPUT_RATE,
                         layer_firing: float = DEFAULT_LAYER_FIRING
                         ) -> tuple[float, ...]:
    """Spikes/timestep per layer when no measurements are available."""
    rates = [input_rate * layer_sizes[0]]
    rates += [layer_firing * n for n in layer_sizes[1:]]
    return tuple(float(r) for r in rates)


def from_layer_sizes(layer_sizes: Sequence[int],
                     spike_rates: Sequence[float] | None = None,
                     kinds: Sequence[str] | None = None) -> NetworkGraph:
    sizes = [int(s) for s in layer_sizes]
    kinds = list(kinds) if kinds is not None else (
        ["input"] + ["dense"] * (len(sizes) - 1))
    layers = tuple(
        LayerSpec(index=i, n_neurons=n,
                  fan_in=0 if i == 0 else sizes[i - 1], kind=kinds[i],
                  name=f"L{i}")
        for i, n in enumerate(sizes))
    rates = (tuple(float(r) for r in spike_rates) if spike_rates is not None
             else estimate_spike_rates(sizes))
    return NetworkGraph(layers=layers, spike_rates=rates)


def from_weights(weights: Sequence,
                 spike_rates: Sequence[float] | None = None) -> NetworkGraph:
    """Dense SNN described by per-layer weight matrices [(n_pre, n_post)]."""
    sizes = [int(weights[0].shape[0])] + [int(w.shape[1]) for w in weights]
    return from_layer_sizes(sizes, spike_rates)


def from_snn_config(cfg, spike_rates: Sequence[float] | None = None
                    ) -> NetworkGraph:
    """models/snn.py SNNConfig frontend."""
    return from_layer_sizes(cfg.layer_sizes, spike_rates)


def from_conv_config(cfg, spike_rates: Sequence[float] | None = None
                     ) -> NetworkGraph:
    """models/snn_conv.py ConvSNNConfig frontend.

    Conv layers map onto cores im2col-style: a stage with C_out channels at
    H x W spatial resolution is H*W*C_out neurons with k*k*C_in fan-in.
    Average-pool halves H and W between stages; the dense head follows.
    """
    h, w, c_in = cfg.in_shape
    sizes = [h * w * c_in]
    fan_ins = [0]
    kinds = ["input"]
    for c_out in cfg.channels:
        sizes.append(h * w * c_out)
        fan_ins.append(cfg.kernel * cfg.kernel * c_in)
        kinds.append("conv")
        h, w, c_in = h // 2, w // 2, c_out
    sizes.append(cfg.n_classes)
    fan_ins.append(h * w * c_in)
    kinds.append("dense")
    layers = tuple(
        LayerSpec(index=i, n_neurons=n, fan_in=f, kind=k, name=f"L{i}")
        for i, (n, f, k) in enumerate(zip(sizes, fan_ins, kinds)))
    rates = (tuple(float(r) for r in spike_rates) if spike_rates is not None
             else estimate_spike_rates(sizes))
    return NetworkGraph(layers=layers, spike_rates=rates)


def measure_spike_rates(weights: Sequence, spike_train,
                        lif=None, device=None) -> tuple[float, ...]:
    """Run a dense SNN on a real spike train (T, n_in) and measure the mean
    spikes/timestep each layer emits — the profile-guided traffic input to
    placement.  Runs on `device` (default: the card, see
    `repro_torch.resolve_device`), unless the weights are already tensors
    and no device is given: then it runs where they lie."""
    import torch

    from repro_torch.core.neuron import LIFParams, init_state, lif_step
    from repro_torch.device import resolve_device

    lif = lif or LIFParams()
    ws = [w.to(torch.float32)
          if isinstance(w, torch.Tensor) and device is None
          else torch.as_tensor(w, dtype=torch.float32,
                               device=resolve_device(device))
          for w in weights]
    spike_train = torch.as_tensor(spike_train, dtype=torch.float32,
                                  device=ws[0].device)
    T = int(spike_train.shape[0])
    states = [init_state(int(w.shape[1]), device=w.device) for w in ws]
    totals = [float(spike_train.sum())] + [0.0] * len(ws)
    for t in range(T):
        spikes = spike_train[t]
        for li, w in enumerate(ws):
            st, out, _ = lif_step(states[li], spikes @ w, lif)
            states[li] = st
            totals[li + 1] += float(out.sum())
            spikes = out
    return tuple(tot / max(T, 1) for tot in totals)


# ---------------------------------------------------------------------------
# Hardware target
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """The mapping target: one or more 20-core fullerene domains."""

    n_cores: int = NOC.N_CORES                  # per level-1 domain
    neurons_per_core: int = E.NEURONS_PER_CORE
    max_domains: int = 1
    router: NOC.RouterParams = NOC.RouterParams()
    interconnect: E.InterconnectEnergyModel | None = None

    def __post_init__(self):
        if self.interconnect is None:
            # derive level-1 hop prices from the router so the placement
            # cost and the replayed NoC energy always agree
            object.__setattr__(
                self, "interconnect",
                E.InterconnectEnergyModel.from_router(self.router))

    def capacity(self, n_domains: int | None = None) -> int:
        d = self.max_domains if n_domains is None else n_domains
        return d * self.n_cores * self.neurons_per_core

    def domains_needed(self, n_groups: int) -> int:
        return max(1, math.ceil(n_groups / self.n_cores))

    def validate_network(self, net: NetworkGraph) -> None:
        need = net.total_neurons
        cap = self.capacity()
        if need > cap:
            raise ValueError(
                f"network needs {need} neurons but chip capacity is {cap} "
                f"({self.max_domains} domain(s) x {self.n_cores} cores x "
                f"{self.neurons_per_core} neurons/core)")
