"""LM training loop: the train step, the data pipeline and the
fault-tolerant runtime, on one device or on a device mesh.

Port of `repro.train.trainer`: restore-or-init -> `FaultTolerantLoop`
with async checkpoints and the straggler policy, over the port's
`TokenStream`.  Without a mesh the model runs on one device (the card
unless the caller asks for the CPU); with `mesh=` (a ("data", "model")
`DeviceMesh`, `launch/mesh.py`) the parameters and AdamW moments are
laid out by `launch.steps.train_shardings` and each batch is sharded on
"data", as the reference's sharded, jitted step.

Checkpoints are the reference's: the state {"params", "opt"} is written
as the reference's nested parameter dict with stacked (L, ...) blocks
and its `AdamWState` (leaf keys `params/blocks/wq`, `opt/step`,
`opt/m/blocks/wq`, ...), through `convert.lm_tree`, so a checkpoint of
either package resumes in the other.  On a mesh the full tensors are
gathered and rank 0 writes them; a restore lays them out on the current
mesh, whatever mesh wrote them.
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
from repro_torch.distributed import sharding as SH
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


def _full(named: dict) -> dict:
    """Tensors by name, DTensors gathered whole (a collective: every
    rank calls it)."""
    return {k: SH.full(t) for k, t in named.items()}


def _reference_layout(state: dict) -> dict:
    """{"params": Transformer, "opt": AdamWState} as the reference's
    state tree, of full tensors."""
    opt = state["opt"]
    return {"params": lm_tree(_full(dict(state["params"].named_parameters()))),
            "opt": adamw.AdamWState(step=opt.step, m=lm_tree(_full(opt.m)),
                                    v=lm_tree(_full(opt.v)))}


def _is_writer() -> bool:
    """Rank 0 of a process group (or no group) writes checkpoints."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


class _ReferenceLayoutCheckpoints:
    """A `CheckpointManager` that stores the trainer's state in the
    reference's layout and restores it into the state in place.  On a
    mesh every rank gathers the full tensors and rank 0 writes them."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager

    def save(self, step: int, state: dict, blocking: bool = False):
        tree = _reference_layout(state)
        if _is_writer():
            self.manager.save(step, tree, blocking=blocking)

    def wait(self):
        if _is_writer():
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
    def __init__(self, cfg: ArchConfig, job: TrainJobConfig, mesh=None,
                 device=None):
        self.cfg = cfg
        self.job = job
        self.mesh = mesh
        self.device = resolve_device(device)
        self.opt_cfg = adamw.AdamWConfig(lr=job.lr, warmup_steps=10,
                                         total_steps=job.num_steps)
        self.data = TokenStream(vocab=cfg.vocab, seq_len=job.seq_len,
                                batch=job.batch, seed=job.seed)
        self.ckpt = CheckpointManager(job.ckpt_dir)
        self.step_fn = ST.make_train_step(cfg, self.opt_cfg, mesh)

    def init_state(self) -> dict:
        """Random weights from the port's init (seed `job.seed`) and a
        fresh AdamW state, on the trainer's device (on a mesh, each rank
        keeps its shards of them)."""
        params = T.init_model(self.cfg, torch.Generator(
            device=self.device).manual_seed(self.job.seed))
        if self.mesh is not None:
            params = ST.shard_params(params, self.mesh)
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
