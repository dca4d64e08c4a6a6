"""Continual on-chip adaptation — the deploy-tier payoff of the
plasticity subsystem (core/plasticity.py).  Port of `repro.deploy.adapt`.

Scenario: an edge device ships with an offline-trained, quantized SNN.
In the field the input statistics drift — modeled here as a global
rotation of the event-camera motion directions
(`EventStream.angle_offset`); an offset of one class slot
(2*pi/n_classes) permutes the class-conditional input distributions, so
the deployed readout collapses toward chance.  The device cannot
retrain offline: that means shipping every observed event train over
the host DMA link, retraining off-device, and re-programming the
register tables.  It CAN adapt on-chip: reward-modulated STDP on the
readout layer (`PlasticityConfig(mode="reward")`) accumulates an
eligibility trace during each trial and commits a handful of priced
register-table index writes per labeled trial — microjoules vs the
DMA round-trip.

`continual_adaptation` runs the whole story and measures it:

    train (QAT) -> quantize -> deploy -> drift -> adapt on-chip

returning an `AdaptReport` with the three accuracies (clean, drifted,
adapted), the full adaptation energy ledger (inference pJ, weight-write
pJ — itemized via `energy.WeightWriteModel` — and input-DMA pJ) and the
off-device alternative's DMA+reprogram cost for the same trial budget.
The recovery gate:

    acc_adapted - acc_drift >= recovery_frac * (acc_base - acc_drift)

i.e. on-chip learning must claw back at least half (by default) of the
drift-induced accuracy loss, at a write-energy budget it itemizes.

Everything runs on `device` (default: the card).  The trials' trains
are drawn on the host in one pass and cross to the device in one copy;
the learned indexes stay on the device from trial to trial.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.plasticity import PlasticityConfig
from repro_torch.core.quant import CodebookConfig
from repro_torch.core.soc import ChipSimulator, HostDmaModel
from repro_torch.data.synthetic import EventStream
from repro_torch.device import resolve_device
from repro_torch.models.snn import SNNConfig
from repro_torch.train.snn_trainer import SNNTrainConfig, SNNTrainer


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Continual-adaptation scenario knobs (defaults = CI-smoke scale)."""

    # offline pre-training
    height: int = 8
    width: int = 8
    timesteps: int = 6
    hidden: int = 64
    n_classes: int = 10
    train_steps: int = 60
    train_batch: int = 64
    train_lr: float = 4e-3
    seed: int = 0

    # chip + plasticity
    n_levels: int = 16
    bit_width: int = 8
    plast_lr: float = 0.05        # reward * eligibility -> level step
    tau_elig: float = 10.0
    elig_pre: float = 0.5         # lets reward recruit silent readouts
    engine: str = "compiled"

    # drift + adaptation budget
    drift: float | None = None    # None => one class slot (2*pi/n_classes)
    n_trials: int = 128           # labeled adaptation trials (batch 1)
    eval_batch: int = 128
    recovery_frac: float = 0.5    # gate: fraction of the loss recovered

    @property
    def drift_offset(self) -> float:
        return (2.0 * np.pi / self.n_classes if self.drift is None
                else self.drift)


@dataclasses.dataclass
class AdaptReport:
    """One continual-adaptation run, fully itemized."""

    # accuracies
    acc_base: float               # clean eval, deployed indexes
    acc_drift: float              # drifted eval, deployed indexes
    acc_adapted: float            # drifted eval, learned indexes
    recovered_frac: float         # (adapted-drift)/(base-drift)
    recovery_frac_gate: float
    recovered: bool               # recovered_frac >= gate

    # adaptation ledger (over n_trials labeled trials, batch 1).  The
    # deployed device runs inference on every observed trial regardless
    # of how it adapts, so the *marginal* cost of on-chip learning is
    # the committed register writes; inference/upload pJ are itemized
    # for the full picture.
    n_trials: int
    weight_writes: float          # committed register index writes
    write_energy_pj: float        # WeightWriteModel-priced (the margin)
    infer_energy_pj: float        # chip inference pJ across trials
    upload_energy_pj: float       # sensor->chip spike DMA across trials
    onchip_total_pj: float        # writes + inference + upload
    write_pj_share: float         # write pJ / on-chip total

    # the off-device alternative's *marginal* cost, same trial budget:
    # ship every train to the host + re-program the register tables
    # (host retraining compute not even counted)
    offline_dma_pj: float
    offline_reprogram_pj: float
    offline_total_pj: float
    onchip_advantage_x: float     # offline marginal / write_energy_pj

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _eval_acc(sim: ChipSimulator, spikes, labels: np.ndarray,
              learned=None) -> float:
    counts, _ = sim.run_batch(spikes, learned=learned)
    return float(np.mean(np.argmax(counts.cpu().numpy(), axis=-1)
                         == labels))


def _host_batch(ev: EventStream, n: int, step: int, dev: torch.device):
    """(spikes on `dev`, labels on the host) of `ev.batch(n, step)`."""
    spikes, labels = ev._batch_numpy(n, step)
    return torch.from_numpy(spikes).to(dev), labels


def continual_adaptation(cfg: AdaptConfig | None = None,
                         verbose: bool = False,
                         device=None) -> AdaptReport:
    """Run the full drift-and-adapt scenario on `device` (default: the
    card); see the module docstring."""
    cfg = cfg or AdaptConfig()
    dev = resolve_device(device)
    log = print if verbose else (lambda *a, **k: None)

    # ---- offline pre-training (QAT so PTQ is lossless-ish) -----------
    ev = EventStream(n_classes=cfg.n_classes, height=cfg.height,
                     width=cfg.width, timesteps=cfg.timesteps,
                     seed=cfg.seed)
    quant = CodebookConfig(n_levels=cfg.n_levels, bit_width=cfg.bit_width)
    net = SNNConfig(layer_sizes=(ev.n_inputs, cfg.hidden, cfg.n_classes),
                    timesteps=cfg.timesteps, qat=True, quant=quant)
    params, _ = SNNTrainer(
        net, SNNTrainConfig(steps=cfg.train_steps, batch=cfg.train_batch,
                            lr=cfg.train_lr, log_every=0), device=dev
    ).fit(lambda step: ev.batch(cfg.train_batch, step, device=dev))
    log(f"== trained {net.layer_sizes} x T={cfg.timesteps} (QAT) ==")

    # ---- deploy with reward-modulated plasticity on the readout ------
    readout = len(params) - 1
    plast = PlasticityConfig(enabled=True, mode="reward",
                             lr=cfg.plast_lr, tau_elig=cfg.tau_elig,
                             elig_pre=cfg.elig_pre, layers=(readout,))
    sim = ChipSimulator(params, quant_cfg=quant, engine=cfg.engine,
                        plasticity=plast, device=dev)
    dma = HostDmaModel()

    eval_sp, eval_lb = _host_batch(ev, cfg.eval_batch, 700_001, dev)
    acc_base = _eval_acc(sim, eval_sp, eval_lb)

    # ---- drift: rotate every motion direction by one class slot ------
    drifted = dataclasses.replace(ev, angle_offset=cfg.drift_offset)
    dr_sp, dr_lb = _host_batch(drifted, cfg.eval_batch, 700_002, dev)
    acc_drift = _eval_acc(sim, dr_sp, dr_lb)
    log(f"== drift {cfg.drift_offset:.3f} rad: accuracy "
        f"{acc_base:.3f} -> {acc_drift:.3f} ==")

    # ---- on-chip adaptation: R-STDP over labeled trials --------------
    # every trial's train is the reference's batch(1, 900_000 + trial),
    # drawn here in one pass and copied to the device in one transfer
    trials = [drifted._batch_numpy(1, 900_000 + trial)
              for trial in range(cfg.n_trials)]
    trial_sp = torch.from_numpy(np.stack([s for s, _ in trials])).to(dev)
    eye = np.eye(cfg.n_classes, dtype=np.float32)
    state = None
    writes = 0.0
    write_pj = 0.0
    infer_pj = 0.0
    upload_pj = 0.0
    for trial in range(cfg.n_trials):
        counts, reports = sim.run_batch(trial_sp[trial], learned=state)
        pred = int(counts[0].argmax())
        # three-factor error vector: push the target up, the prediction
        # down, scaled by each synapse's accumulated eligibility
        reward = eye[int(trials[trial][1][0])] - eye[pred]
        info = sim.apply_reward(reward)
        # the learned indexes stay on the device for the next trial
        state = [None if l is None else l[0] for l in sim.last_learned]
        writes += float(info["weight_writes"][0])
        write_pj += float(info["write_energy_pj"][0])
        infer_pj += reports[0].energy_pj
        upload_pj += dma.spike_upload(cfg.timesteps, ev.n_inputs)[0]
    acc_adapted = _eval_acc(sim, dr_sp, dr_lb, learned=state)
    log(f"== adapted over {cfg.n_trials} trials: accuracy "
        f"{acc_adapted:.3f}, {writes:.0f} index writes "
        f"({write_pj:.1f} pJ) ==")

    # ---- the off-device alternative, same trial budget ---------------
    # ship every observed train to the host for retraining, then
    # re-program the full register-table set (NPARAM.INIT reload)
    offline_dma = (dma.spike_upload(cfg.timesteps, ev.n_inputs)[0]
                   * cfg.n_trials)
    offline_reprog = dma.table_load(sim.register_tables)[0]

    loss = max(acc_base - acc_drift, 1e-9)
    recovered_frac = (acc_adapted - acc_drift) / loss
    onchip_total = write_pj + infer_pj + upload_pj
    offline_total = offline_dma + offline_reprog
    return AdaptReport(
        acc_base=acc_base, acc_drift=acc_drift, acc_adapted=acc_adapted,
        recovered_frac=float(recovered_frac),
        recovery_frac_gate=cfg.recovery_frac,
        recovered=bool(recovered_frac >= cfg.recovery_frac),
        n_trials=cfg.n_trials,
        weight_writes=writes, write_energy_pj=write_pj,
        infer_energy_pj=infer_pj, upload_energy_pj=upload_pj,
        onchip_total_pj=onchip_total,
        write_pj_share=write_pj / max(onchip_total, 1e-300),
        offline_dma_pj=float(offline_dma),
        offline_reprogram_pj=float(offline_reprog),
        offline_total_pj=float(offline_total),
        onchip_advantage_x=float(offline_total / max(write_pj, 1e-300)))
