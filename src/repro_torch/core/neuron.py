"""LIF neuron model with partial membrane-potential (MP) update (paper C2),
in torch.  Port of `repro.core.neuron`, with the surrogate gradient of
BPTT training: `spike_fn` is an `autograd.Function`, a Heaviside forward
and a fast-sigmoid backward.

Partial update only touches neurons that received at least one valid
input spike this timestep; untouched neurons keep their raw potential and
count pending leak steps in `elapsed`, applied lazily as
`leak ** (elapsed + 1)` when next touched — exactly the dense update.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """Neuron configuration (the chip's per-core register-table fields)."""

    threshold: float = 1.0
    leak: float = 0.9            # multiplicative leak alpha in [0, 1]
    reset: float = 0.0           # reset potential after a spike
    reset_mode: str = "hard"     # "hard" (V<-reset) or "soft" (V<-V-theta)
    partial_update: bool = True  # paper C2: skip neurons with no input
    surrogate_beta: float = 4.0  # steepness of the surrogate gradient


class LIFState(NamedTuple):
    """Carry for a population of LIF neurons."""

    v: torch.Tensor          # membrane potential, f32 (..., n)
    elapsed: torch.Tensor    # int32 timesteps since last touch (lazy leak)


def init_state(n: int, batch: tuple[int, ...] = (), device=None
               ) -> LIFState:
    """Zero state on `device` (default: the card, see
    `repro_torch.resolve_device`)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    shape = tuple(batch) + (n,)
    return LIFState(v=torch.zeros(shape, dtype=torch.float32, device=dev),
                    elapsed=torch.zeros(shape, dtype=torch.int32, device=dev))


def init_batch_state(batch: int, n: int, device=None) -> LIFState:
    """Zero (batch, n) state on `device` (default: the card)."""
    return init_state(n, (batch,), device)


class SpikeFn(torch.autograd.Function):
    """Heaviside spike with the fast-sigmoid surrogate gradient:
    d/dx [x / (1 + beta|x|)] = 1 / (1 + beta|x|)^2 (the reference's
    `spike_fn` custom VJP)."""

    @staticmethod
    def forward(ctx, x, beta):
        ctx.save_for_backward(x)
        ctx.beta = beta
        return (x >= 0.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (1.0 / (1.0 + ctx.beta * x.abs()) ** 2), None


def spike_fn(v_minus_theta: torch.Tensor, beta: float) -> torch.Tensor:
    """Heaviside spike; differentiable through `SpikeFn` when its input
    requires grad, else the bare comparison (inference issues no extra
    op)."""
    if v_minus_theta.requires_grad and torch.is_grad_enabled():
        return SpikeFn.apply(v_minus_theta, beta)
    return (v_minus_theta >= 0.0).to(v_minus_theta.dtype)


def lif_step(state: LIFState, current: torch.Tensor, p: LIFParams,
             touched: torch.Tensor | None = None,
             ) -> tuple[LIFState, torch.Tensor, torch.Tensor]:
    """One LIF timestep -> (new_state, spikes, updated_mask).

    `touched` optionally supplies the partial-update mask explicitly (the
    connectivity mask of `touch_mask`, integer-exact); without it the mask
    falls back to ``current != 0``.
    """
    has_input = (current != 0.0) if touched is None else touched
    v = state.v
    if p.partial_update:
        pending = state.elapsed + 1
        # Lazy leak: apply alpha**pending only for touched neurons.
        decay = torch.where(has_input, p.leak ** pending.to(v.dtype),
                            torch.ones_like(v))
        v_int = v * decay + current
        # Untouched neurons keep raw v and bump `elapsed`.
        new_elapsed = torch.where(has_input, torch.zeros_like(pending),
                                  pending)
        # A neuron can only fire when touched (its readout happens on touch).
        v_eff = torch.where(has_input, v_int, torch.full_like(v, -torch.inf))
        spikes = spike_fn(v_eff - p.threshold, p.surrogate_beta)
        updated = has_input
    else:
        v_int = v * p.leak + current
        spikes = spike_fn(v_int - p.threshold, p.surrogate_beta)
        new_elapsed = torch.zeros_like(state.elapsed)
        updated = torch.ones_like(has_input)

    if p.reset_mode == "hard":
        v_reset = torch.where(spikes > 0, torch.full_like(v, p.reset),
                              torch.where(updated, v_int, v))
    else:  # soft reset
        v_reset = torch.where(updated, v_int - spikes * p.threshold, v)
    return LIFState(v=v_reset, elapsed=new_elapsed), spikes, updated


def touch_mask(spikes: torch.Tensor, nonzero_w: torch.Tensor) -> torch.Tensor:
    """Connectivity-driven partial-update mask: a neuron is touched when a
    valid spike reaches one of its nonzero synapses.  The counts are small
    integers, exact in f32 under any summation order."""
    return (spikes @ nonzero_w) > 0


def settle_state(state: LIFState, p: LIFParams) -> LIFState:
    """Flush pending lazy leak (used at readout / end of sample)."""
    decay = p.leak ** state.elapsed.to(state.v.dtype)
    return LIFState(v=state.v * decay,
                    elapsed=torch.zeros_like(state.elapsed))


def dense_reference_step(state: LIFState, current: torch.Tensor,
                         p: LIFParams) -> tuple[LIFState, torch.Tensor]:
    """Traditional (baseline) scheme: the full MP update every step —
    the oracle that shows partial update preserves the semantics, and
    the energy baseline (the paper's 2.69x comparison point)."""
    new_state, spikes, _ = lif_step(
        state, current, dataclasses.replace(p, partial_update=False))
    return new_state, spikes


def run_timesteps(state: LIFState, currents: torch.Tensor, p: LIFParams
                  ) -> tuple[LIFState, torch.Tensor, torch.Tensor]:
    """`lif_step` over a (T, ..., n) current tensor: (final state, spikes
    (T, ..., n), updated neurons per step (T,) int32), the reference's
    scan as a loop over T."""
    spikes, counts = [], []
    for cur in currents:
        state, spk, upd = lif_step(state, cur, p)
        spikes.append(spk)
        counts.append(upd.sum(dtype=torch.int32))
    return state, torch.stack(spikes), torch.stack(counts)
