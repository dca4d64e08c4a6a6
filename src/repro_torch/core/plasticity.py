"""On-chip synaptic plasticity — trace-based STDP constrained to the
chip's codebook weight format, in torch.  Port of `repro.core.plasticity`.

The chip stores a synapse as a log2(N)-bit *index* into the core's shared
N x W-bit weight table (paper C3), so learning cannot move a weight
freely: an update is computed in float, added to the current level, and
projected back to the nearest table entry (`quant.project_to_codebook`).
A step that does not cross the midpoint between two levels writes
nothing; a step that does costs one register-file index write, priced by
`energy.WeightWriteModel` and scheduled as the plasticity stage of
`zspe.CycleModel`.

Two local rules, selected by `PlasticityConfig.mode`:

* ``"stdp"`` — online pairwise STDP from exponential pre/post traces:

      x_pre'  = x_pre * exp(-1/tau_pre)  + pre
      x_post' = x_post * exp(-1/tau_post) + post
      dw      = lr * (a_plus * x_pre' (x) post  -  a_minus * pre (x) x_post')

  applied (and projected, and priced) every timestep.

* ``"reward"`` — three-factor reward-modulated variant: the same pairing
  term (plus an optional presynaptic-only component, `elig_pre`)
  accumulates into a decaying eligibility trace during the trial, and a
  scalar or per-postsynaptic-neuron reward converts it to weight updates
  at trial end (`apply_reward`) — one batched register write per trial.

Every engine of the port (compiled, fused and the interpretive reference)
calls these functions, so the rules are one implementation.  Each is a
fixed sequence of elementwise torch ops, so a given element rounds the
same way whatever the batch or padding around it: the fused and compiled
engines learn bit-identical indexes.  Against the reference's jnp, XLA
may contract `x * decay + s` into one FMA, so traces agree within a few
ulp and indexes are equal away from midpoints between levels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import quant as Q

_MODES = ("stdp", "reward")


@dataclasses.dataclass(frozen=True)
class PlasticityConfig:
    """Learning-rule configuration (a per-chip register block, like
    `TraceConfig`): which layers learn, which rule, and its constants.

    `layers` selects learnable layers by index (None = all); every
    learnable layer must lower to table-exact codebook indexes — the
    engines raise otherwise, since the chip has nothing to write to.
    """

    enabled: bool = False
    mode: str = "stdp"            # "stdp" | "reward"
    lr: float = 0.05              # float update step before projection
    a_plus: float = 1.0           # potentiation (pre-trace x post-spike)
    a_minus: float = 1.0          # depression (pre-spike x post-trace)
    tau_pre: float = 2.0          # pre-trace decay, in timesteps
    tau_post: float = 2.0         # post-trace decay, in timesteps
    tau_elig: float = 10.0        # eligibility decay (reward mode)
    elig_pre: float = 0.0         # presynaptic-only eligibility term
                                  # (reward mode): lets reward potentiate
                                  # synapses onto silent target neurons
    layers: tuple | None = None   # learnable layer indexes; None = all

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if self.layers is not None:
            object.__setattr__(self, "layers",
                               tuple(int(li) for li in self.layers))

    def learns(self, li: int) -> bool:
        return self.enabled and (self.layers is None
                                 or int(li) in self.layers)

    # decay factors are host floats from numpy, as in the reference, so
    # every engine multiplies by the same f32 constant
    @property
    def decay_pre(self) -> float:
        return float(np.exp(-1.0 / self.tau_pre))

    @property
    def decay_post(self) -> float:
        return float(np.exp(-1.0 / self.tau_post))

    @property
    def decay_elig(self) -> float:
        return float(np.exp(-1.0 / self.tau_elig))


NULL_PLASTICITY = PlasticityConfig()


# ---------------------------------------------------------------------------
# shared rule arithmetic — the ONLY implementation, used by every engine
# ---------------------------------------------------------------------------
#
# Shapes: `pre` (..., K), `post` (..., N), traces match, `idx` (..., K, N)
# int8, `cbw` (L, N) f32.  Leading axes are free: the array engines call
# these with an explicit batch axis, the reference engine per sample.


def as_indexes(src, device) -> torch.Tensor:
    """Caller-given learned indexes (a tensor, or an array such as a
    read-only view of the reference's) as int8 on `device`."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.array(src, np.int8))
    return src.to(device, torch.int8)


def dequant_indices(idx: torch.Tensor, cbw: torch.Tensor) -> torch.Tensor:
    """Per-column codebook gather: w[..., k, n] = cbw[idx[..., k, n], n],
    an index outside [0, L) read by JAX's gather rule
    (`quant.gather_index`), as the reference's `cbw[idx, cols]` reads it."""
    flat = Q.gather_index(idx.reshape(-1, idx.shape[-1]), cbw.shape[0])
    return torch.gather(cbw, 0, flat).reshape(idx.shape)


def _traces(cfg: PlasticityConfig, pre, post, x_pre, x_post):
    return (x_pre * cfg.decay_pre + pre,
            x_post * cfg.decay_post + post)


def _pair(cfg: PlasticityConfig, pre, post, x_pre, x_post):
    """The STDP pairing term from *updated* traces (online rule: a
    coincident pre+post this step contributes to both windows).  The
    reference's products in its order; the (..., K, N) difference is
    taken in place."""
    ltp = (cfg.a_plus * x_pre)[..., :, None] * post[..., None, :]
    return ltp.sub_((cfg.a_minus * pre)[..., :, None] * x_post[..., None, :])


def stdp_step(cfg: PlasticityConfig, pre, post, x_pre, x_post, idx, cbw):
    """One in-run STDP update: returns (idx', x_pre', x_post', changed).

    `changed` is the boolean write mask — every True is one register-file
    index write the cycle/energy models price.  Projection of an
    unchanged level is a fixed point (first-occurrence tie-breaking), so
    dw == 0 never writes.
    """
    x_pre, x_post = _traces(cfg, pre, post, x_pre, x_post)
    # w + lr * pair, rounded as the reference rounds it (an IEEE add is
    # commutative), in the pair's buffer
    cand = _pair(cfg, pre, post, x_pre, x_post).mul_(cfg.lr).add_(
        dequant_indices(idx, cbw))
    new_idx = Q.project_to_codebook(cand, cbw)
    return new_idx, x_pre, x_post, new_idx != idx


def elig_step(cfg: PlasticityConfig, pre, post, x_pre, x_post, elig):
    """Reward mode, in-run: accumulate eligibility, write nothing."""
    x_pre, x_post = _traces(cfg, pre, post, x_pre, x_post)
    e = _pair(cfg, pre, post, x_pre, x_post)
    if cfg.elig_pre:
        e = e + cfg.elig_pre * x_pre[..., :, None]
    return x_pre, x_post, elig * cfg.decay_elig + e


def apply_reward(cfg: PlasticityConfig, idx, cbw, elig, reward):
    """Trial-end commit: eligibility x reward -> projected index writes.

    `reward` is a scalar (classic dopamine broadcast) or a per-output-
    neuron array broadcastable to the layer's post axis (a three-factor
    error vector, e.g. one_hot(target) - one_hot(predicted)).  Returns
    (idx', changed).
    """
    r = torch.as_tensor(reward, dtype=torch.float32, device=elig.device)
    if r.dim():
        r = r[..., None, :]
    cand = dequant_indices(idx, cbw) + cfg.lr * r * elig
    new_idx = Q.project_to_codebook(cand, cbw)
    return new_idx, new_idx != idx


def commit_reward(cfg: PlasticityConfig, tables, learned, eligs, reward,
                  write_model, cycle_model):
    """Host-side reward epilogue shared by the array engines and the
    reference engine: apply `apply_reward` to every learnable layer and
    price the resulting register writes.

    `tables[li]` is None or the layer's (idx0, cbw) lowering, `learned` /
    `eligs` the per-layer learned indexes and eligibilities from the last
    run (batch-leading).  Returns (new_learned, info) where info holds
    per-sample f64 `weight_writes`, `write_energy_pj`, `write_cycles`.
    """
    new_learned: list = []
    writes = None
    r_shape = tuple(torch.as_tensor(reward).shape)
    for li, pt in enumerate(tables):
        if pt is None:
            new_learned.append(None)
            continue
        cbw = pt[1]
        if r_shape and r_shape[-1] != cbw.shape[-1]:
            raise ValueError(
                f"per-neuron reward has width {r_shape[-1]} but learnable "
                f"layer {li} has {cbw.shape[-1]} outputs — restrict "
                "PlasticityConfig.layers to the readout layer (or use a "
                "scalar reward)")
        nidx, changed = apply_reward(cfg, learned[li], cbw,
                                     eligs[li], reward)
        new_learned.append(nidx)
        w = changed.sum(dim=(-2, -1)).cpu().numpy().astype(np.float64)
        writes = w if writes is None else writes + w
    if writes is None:
        raise ValueError("no learnable layers to commit a reward into")
    info = {
        "weight_writes": writes,
        "write_energy_pj": write_model.write_pj(writes),
        # the commit is one burst through the plasticity write stage
        "write_cycles": np.ceil(writes / cycle_model.geom.write_lanes),
    }
    return new_learned, info
