"""Spiking neural network model — the paper's native workload, in torch.

Port of `repro.models.snn`: a feed-forward LIF MLP driven by event spike
trains, built from the core modules (ZSPE spike-matmul semantics, partial
membrane update, per-layer codebook weights), trainable with
surrogate-gradient BPTT (`core.neuron.spike_fn`).  The reference scans
the timesteps under `jax.jit`; the port runs them as an eager loop, so
autograd records the unrolled graph BPTT walks back.  The layer product
`cur_in @ w` is a `torch.matmul`, as the reference computes it in jnp
outside any kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.neuron import LIFParams, LIFState, lif_step
from repro_torch.core.quant import CodebookConfig, fake_quant
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    layer_sizes: tuple = (2312, 512, 10)
    timesteps: int = 20
    lif: LIFParams = LIFParams()
    qat: bool = False                       # train with fake-quant (STE)
    quant: CodebookConfig = CodebookConfig(n_levels=16, bit_width=8)


def init_params(cfg: SNNConfig, generator: torch.Generator | None = None,
                device=None) -> list[torch.Tensor]:
    """He-normal (n_pre, n_post) f32 weights, drawn on the CPU from
    `generator` (default: seed 0) and placed on `device` (default: the
    card), so a seed gives the same weights on every device."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    sizes = cfg.layer_sizes
    return [(torch.randn((a, b), generator=gen, dtype=torch.float32)
             * (2.0 / a) ** 0.5).to(dev)
            for a, b in zip(sizes[:-1], sizes[1:])]


def _layer_weights(w: torch.Tensor, cfg: SNNConfig) -> torch.Tensor:
    if cfg.qat:
        return fake_quant(w, cfg.quant.n_levels, cfg.quant.bit_width)
    return w


def forward(params: Sequence[torch.Tensor], cfg: SNNConfig,
            spikes: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """spikes (B, T, N_in) -> (spike-count logits (B, n_out), stats).

    stats feeds both the energy model and the hardware-aware training
    losses (train/snn_trainer.py):
      * performed/nominal SOPs, sparsity, touched — chip accounting;
      * "rates" — per-layer mean firing rate (L,), DIFFERENTIABLE through
        the surrogate gradient;
      * "density" / "touch_fraction" — the two chip efficiency knobs as
        plain fractions (reporting; not differentiable).
    """
    b, t, _ = spikes.shape
    dev = spikes.device
    weights = [_layer_weights(w, cfg) for w in params]
    states = [LIFState(v=torch.zeros((b, w.shape[1]), device=dev),
                       elapsed=torch.zeros((b, w.shape[1]),
                                           dtype=torch.int32, device=dev))
              for w in weights]
    nominal_per_step = b * float(
        sum(wa * wb for wa, wb in zip(cfg.layer_sizes[:-1],
                                      cfg.layer_sizes[1:])))
    neuron_steps = b * t * float(sum(cfg.layer_sizes[1:]))

    sops, touched, rates = [], [], []
    counts = None
    for step in range(t):
        cur_in = spikes[:, step]
        tot_sops = torch.zeros((), device=dev)
        tot_touched = torch.zeros((), device=dev)
        step_rates = []
        for li, w in enumerate(weights):
            current = cur_in @ w                      # ZSPE semantics
            nnz = (cur_in != 0).sum()
            tot_sops = tot_sops + (nnz * w.shape[1]).to(torch.float32)
            states[li], out, upd = lif_step(states[li], current, cfg.lif)
            tot_touched = tot_touched + upd.sum().to(torch.float32)
            step_rates.append(out.mean())             # surrogate-grad path
            cur_in = out
        counts = cur_in if counts is None else counts + cur_in
        sops.append(tot_sops)
        touched.append(tot_touched)
        rates.append(torch.stack(step_rates))
    sops_sum = torch.stack(sops).sum()
    touched_sum = torch.stack(touched).sum()
    nominal_total = nominal_per_step * t
    stats = {
        "performed_sops": sops_sum,
        "nominal_sops": torch.tensor(nominal_total, device=dev),
        "sparsity": 1.0 - sops_sum / nominal_total,
        "density": sops_sum / nominal_total,
        "touched": touched_sum,
        "touch_fraction": touched_sum / neuron_steps,
        "rates": torch.stack(rates).mean(dim=0),      # (L,), differentiable
    }
    return counts, stats


def cross_entropy(counts: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Rate-coded readout: softmax over spike counts, mean NLL."""
    logp = torch.log_softmax(counts, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def loss_fn(params, cfg: SNNConfig, spikes, labels):
    counts, stats = forward(params, cfg, spikes)
    return cross_entropy(counts, labels), stats


def accuracy(params, cfg: SNNConfig, spikes, labels) -> torch.Tensor:
    counts, _ = forward(params, cfg, spikes)
    return (counts.argmax(dim=-1) == labels).to(torch.float32).mean()
