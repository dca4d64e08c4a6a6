"""LM training loop: the train step, the data pipeline and the
fault-tolerant runtime, on one card.

Port of `repro.train.trainer`: restore-or-init -> `FaultTolerantLoop`
with async checkpoints and the straggler policy, over the port's
`TokenStream`.  The reference builds a mesh and a sharded, jitted step;
here the model runs on one device (the card unless the caller asks for
the CPU).

Checkpoints are the reference's: the state {"params", "opt"} is written
as the reference's nested parameter dict with stacked (L, ...) blocks
and its `AdamWState` (leaf keys `params/blocks/wq`, `opt/step`,
`opt/m/blocks/wq`, ...), through `convert.lm_tree`, so a checkpoint of
either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import lm_tree, load_lm_tree
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed.elastic import FaultTolerantLoop, StragglerPolicy
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.models.common import ArchConfig
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainJobConfig:
    batch: int = 8
    seq_len: int = 128
    num_steps: int = 100
    save_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    seed: int = 0
    lr: float = 3e-4


def _reference_layout(state: dict) -> dict:
    """{"params": Transformer, "opt": AdamWState} as the reference's
    state tree."""
    opt = state["opt"]
    return {"params": lm_tree(dict(state["params"].named_parameters())),
            "opt": adamw.AdamWState(step=opt.step, m=lm_tree(opt.m),
                                    v=lm_tree(opt.v))}


class _ReferenceLayoutCheckpoints:
    """A `CheckpointManager` that stores the trainer's state in the
    reference's layout and restores it into the state in place."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager

    def save(self, step: int, state: dict, blocking: bool = False):
        self.manager.save(step, _reference_layout(state), blocking=blocking)

    def wait(self):
        self.manager.wait()

    def restore_latest(self, state: dict):
        step, tree = self.manager.restore_latest(_reference_layout(state))
        if step is None:
            return None, None
        opt = state["opt"]
        load_lm_tree(dict(state["params"].named_parameters()),
                     tree["params"])
        load_lm_tree(opt.m, tree["opt"].m)
        load_lm_tree(opt.v, tree["opt"].v)
        return step, {"params": state["params"],
                      "opt": opt._replace(step=tree["opt"].step.to(
                          opt.step.device, torch.int32))}


class Trainer:
    def __init__(self, cfg: ArchConfig, job: TrainJobConfig, device=None):
        self.cfg = cfg
        self.job = job
        self.device = resolve_device(device)
        self.opt_cfg = adamw.AdamWConfig(lr=job.lr, warmup_steps=10,
                                         total_steps=job.num_steps)
        self.data = TokenStream(vocab=cfg.vocab, seq_len=job.seq_len,
                                batch=job.batch, seed=job.seed)
        self.ckpt = CheckpointManager(job.ckpt_dir)
        self.step_fn = ST.make_train_step(cfg, self.opt_cfg)

    def init_state(self) -> dict:
        """Random weights from the port's init (seed `job.seed`) and a
        fresh AdamW state, on the trainer's device."""
        params = T.init_model(self.cfg, torch.Generator(
            device=self.device).manual_seed(self.job.seed))
        return {"params": params,
                "opt": adamw.init(dict(params.named_parameters()))}

    def run(self, on_metrics=None) -> dict:
        loop = FaultTolerantLoop(
            step_fn=self._loop_step,
            ckpt_manager=_ReferenceLayoutCheckpoints(self.ckpt),
            save_every=self.job.save_every,
            straggler=StragglerPolicy(),
        )
        state, start = loop.resume_or_init(self.init_state())
        state, _ = loop.run(
            state, lambda step: self.data.batch_at(step, self.device), start,
            self.job.num_steps, on_metrics=on_metrics)
        return state

    def _loop_step(self, state: dict, batch: dict):
        params, opt, metrics = self.step_fn(state["params"], state["opt"],
                                            batch)
        return {"params": params, "opt": opt}, metrics
