"""Hardware-aware SNN training — the `train` half of the train→deploy
loop, in torch.  Port of `repro.train.snn_trainer`.

The chip's pJ/SOP depends on workloads *trained for* its efficiency
features, so the trainer adds three hardware-aware terms to the
rate-coded cross-entropy:

  * **spike-rate regularization** (`rate_weight`, `target_rate`) — a
    squared hinge on each hidden layer's mean firing rate,
    differentiable through the surrogate gradient: hidden spikes are the
    inputs the next core's ZSPE scans, so lower rates raise the
    zero-skip rate the energy model prices;
  * **synapse pruning** (`l1_weight`) — L1 on the weights, which
    collapse onto the codebook's zero level at PTQ and shrink the
    partial-update touch set;
  * **codebook QAT** (`SNNConfig.qat=True`) — `quant.fake_quant` (STE) in
    the forward.

BPTT is eager autograd over the unrolled timesteps (`models/snn.py`);
AdamW (`optim/adamw.py`) updates the parameters, `CheckpointManager`
(`checkpoint/manager.py`) snapshots them and resumes from the newest
complete step.  Metrics of a step cross to the host in one copy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.models import snn as SNN
from repro_torch.models.snn import SNNConfig
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class HWLossConfig:
    """Weights/targets of the hardware-aware loss terms (all off by 0.0)."""

    rate_weight: float = 0.0     # spike-rate squared hinge -> ZSPE skip rate
    target_rate: float = 0.10    # mean firing rate ceiling per layer
    l1_weight: float = 0.0       # synapse pruning -> partial-update fraction

    def regularized(self) -> bool:
        return self.rate_weight > 0.0 or self.l1_weight > 0.0


@dataclasses.dataclass(frozen=True)
class SNNTrainConfig:
    steps: int = 60
    batch: int = 64
    lr: float = 2e-3
    warmup_steps: int = 5
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    hw: HWLossConfig = HWLossConfig()
    ckpt_dir: str | None = None      # enables save/auto-resume when set
    save_every: int = 0              # 0 => only the final step is saved
    log_every: int = 10


def hw_loss_fn(params, cfg: SNNConfig, hw: HWLossConfig, spikes, labels):
    """Cross-entropy + hardware-aware regularizers.  Returns
    (loss, (ce, stats)) — stats are models.snn forward stats."""
    counts, stats = SNN.forward(params, cfg, spikes)
    ce = SNN.cross_entropy(counts, labels)
    loss = ce
    if hw.rate_weight:
        # hidden layers only: output spikes ARE the rate-coded readout
        excess = torch.clamp(stats["rates"][:-1] - hw.target_rate, min=0.0)
        loss = loss + hw.rate_weight * torch.sum(excess ** 2)
    if hw.l1_weight:
        l1 = sum(torch.mean(torch.abs(w)) for w in params)
        loss = loss + hw.l1_weight * l1
    return loss, (ce, stats)


def train_step(params, opt_state, cfg: SNNConfig, hw: HWLossConfig,
               opt_cfg: adamw.AdamWConfig, spikes, labels):
    """One BPTT + AdamW step -> (params, opt_state, metrics), metrics as
    0-d tensors on the parameters' device."""
    ps = [p.detach().requires_grad_(True) for p in params]
    loss, (ce, stats) = hw_loss_fn(ps, cfg, hw, spikes, labels)
    grads = torch.autograd.grad(loss, ps)
    with torch.no_grad():
        new, opt_state, opt_metrics = adamw.apply(
            opt_cfg, list(grads), opt_state, [p.detach() for p in ps])
    metrics = {
        "loss": loss.detach(), "ce": ce.detach(),
        "density": stats["density"].detach(),
        "touch_fraction": stats["touch_fraction"].detach(),
        "mean_rate": torch.mean(stats["rates"].detach()),
        **opt_metrics,
    }
    return new, opt_state, metrics


class SNNTrainer:
    """Surrogate-gradient BPTT with AdamW, hardware-aware losses and
    checkpoint/auto-resume, on `device` (default: the card).

    >>> tr = SNNTrainer(cfg, SNNTrainConfig(steps=100, hw=HWLossConfig(
    ...     rate_weight=1.0, target_rate=0.08, l1_weight=1e-3)))
    >>> params, history = tr.fit(lambda step: ev.batch(64, step))
    """

    def __init__(self, cfg: SNNConfig, train_cfg: SNNTrainConfig | None = None,
                 device=None):
        self.cfg = cfg
        self.train_cfg = train_cfg or SNNTrainConfig()
        self.device = resolve_device(device)
        t = self.train_cfg
        self.opt_cfg = adamw.AdamWConfig(
            lr=t.lr, warmup_steps=t.warmup_steps, total_steps=max(t.steps, 1),
            weight_decay=t.weight_decay, clip_norm=t.clip_norm)
        self.ckpt = (CheckpointManager(t.ckpt_dir, async_writes=False)
                     if t.ckpt_dir else None)

    def init(self, generator: torch.Generator | None = None):
        params = SNN.init_params(self.cfg, generator, device=self.device)
        return params, adamw.init(params)

    def step(self, params, opt_state, spikes, labels):
        return train_step(params, opt_state, self.cfg, self.train_cfg.hw,
                          self.opt_cfg, spikes, labels)

    def fit(self, batch_fn: Callable[[int], tuple],
            generator: torch.Generator | None = None,
            on_metrics: Callable[[int, dict], None] | None = None):
        """Run `train_cfg.steps` steps of `batch_fn(step) -> (spikes,
        labels)`.  Resumes from the newest complete checkpoint when a
        ckpt_dir is configured.  Returns (params, history)."""
        t = self.train_cfg
        params, opt_state = self.init(generator)
        start = 0
        if self.ckpt is not None:
            latest = self.ckpt.restore_latest(
                {"params": params, "opt": opt_state})
            if latest[0] is not None:
                start = latest[0]
                params, opt_state = latest[1]["params"], latest[1]["opt"]
        history: list[dict] = []
        for step in range(start, t.steps):
            spikes, labels = batch_fn(step)
            params, opt_state, metrics = self.step(
                params, opt_state, spikes, labels)
            keys = list(metrics)
            vals = torch.stack([metrics[k].to(torch.float32)
                                for k in keys]).tolist()
            row = {"step": step, **dict(zip(keys, vals))}
            history.append(row)
            if on_metrics is not None:
                on_metrics(step, row)
            if self.ckpt is not None and t.save_every and \
                    (step + 1) % t.save_every == 0:
                self.ckpt.save(step + 1,
                               {"params": params, "opt": opt_state})
        if self.ckpt is not None and start < t.steps:
            self.ckpt.save(t.steps, {"params": params, "opt": opt_state})
            self.ckpt.wait()
        return params, history

    def evaluate(self, params, spikes, labels) -> dict:
        """Accuracy + the chip-relevant workload statistics."""
        with torch.no_grad():
            counts, stats = SNN.forward(params, self.cfg, spikes)
            acc = (counts.argmax(dim=-1) == labels).to(torch.float32).mean()
            vals = torch.stack([acc, stats["density"], stats["sparsity"],
                                stats["touch_fraction"],
                                stats["rates"].mean()]).tolist()
        return dict(zip(("accuracy", "density", "sparsity",
                         "touch_fraction", "mean_rate"), vals))
