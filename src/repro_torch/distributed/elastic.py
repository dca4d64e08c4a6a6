"""Elastic scaling, straggler mitigation and fault handling of the
training loop.

Port of `repro.distributed.elastic`.  The paper's NoC has these
mechanisms in silicon: the CMRouter's link controller raises *hang-up*
signals on blocked links or out-of-sync timesteps, and the level-2 router
lets domains join and leave.  At the scale of a training job:

  * StragglerPolicy — per-step deadline; a slow or absent worker
    triggers skip-and-resync, and after `max_strikes` the worker is
    evicted;
  * ElasticPlan — the ("data", "model") mesh for a device count; a
    checkpoint (stored whole, in the reference's layout) restores onto
    whatever mesh the job has now (`train/trainer.py`);
  * FaultTolerantLoop — wraps a step function with checkpoint/restart:
    crash -> restore the latest complete step -> continue.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline-based straggler detection with strike-out eviction."""

    deadline_factor: float = 3.0      # x median step time
    min_deadline_s: float = 1.0
    max_strikes: int = 3
    window: int = 20

    def __post_init__(self):
        self._times: list[float] = []
        self.strikes: dict[int, int] = {}
        self.evicted: set[int] = set()

    def record_step(self, seconds: float):
        self._times.append(seconds)
        self._times = self._times[-self.window:]

    @property
    def deadline_s(self) -> float:
        if not self._times:
            return self.min_deadline_s
        return max(self.min_deadline_s,
                   self.deadline_factor * float(np.median(self._times)))

    def check_worker(self, worker: int, seconds: float) -> str:
        """Returns 'ok' | 'skip' | 'evict' for one worker's step report."""
        if seconds <= self.deadline_s:
            self.strikes.pop(worker, None)
            return "ok"
        self.strikes[worker] = self.strikes.get(worker, 0) + 1
        if self.strikes[worker] >= self.max_strikes:
            self.evicted.add(worker)
            return "evict"
        return "skip"


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Mesh shape for a given device count."""

    n_devices: int
    mesh_shape: tuple
    axes: tuple

    @staticmethod
    def plan(n_devices: int, model_parallel: int = 1) -> "ElasticPlan":
        mp = model_parallel
        while n_devices % mp != 0:
            mp //= 2
        return ElasticPlan(n_devices, (n_devices // mp, mp), ("data", "model"))

    def build_mesh(self, device_type: str = "cpu"):
        """A `DeviceMesh` of this shape over the default process group,
        which must hold exactly `n_devices` ranks."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        have = dist.get_world_size() if dist.is_initialized() else 0
        if have != self.n_devices:
            raise RuntimeError(f"plan for {self.n_devices} devices, the "
                               f"process group has {have}")
        return init_device_mesh(device_type, self.mesh_shape,
                                mesh_dim_names=self.axes)


class FaultTolerantLoop:
    """step_fn wrapper with periodic checkpoints and restart-on-crash.

    `ckpt_manager` needs `save(step, state, blocking=False)`, `wait()`
    and `restore_latest(target) -> (step | None, state)`, as
    `checkpoint.manager.CheckpointManager` has.
    """

    def __init__(self, step_fn: Callable, ckpt_manager, save_every: int = 50,
                 straggler: StragglerPolicy | None = None):
        self.step_fn = step_fn
        self.ckpt = ckpt_manager
        self.save_every = save_every
        self.straggler = straggler or StragglerPolicy()

    def run(self, state, data_iter_at: Callable[[int], dict], start_step: int,
            num_steps: int, on_metrics: Callable | None = None):
        step = start_step
        while step < num_steps:
            t0 = time.time()
            state, metrics = self.step_fn(state, data_iter_at(step))
            dt = time.time() - t0
            self.straggler.record_step(dt)
            if on_metrics:
                on_metrics(step, metrics, dt)
            step += 1
            if step % self.save_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.save(step, state, blocking=True)
        self.ckpt.wait()
        return state, step

    def resume_or_init(self, init_state):
        step, state = self.ckpt.restore_latest(init_state)
        if step is None:
            return init_state, 0
        return state, step
