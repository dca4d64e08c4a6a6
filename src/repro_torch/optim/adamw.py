"""AdamW with decoupled weight decay, global-norm clipping and schedules,
in torch.  Port of `repro.optim.adamw`.

Parameters, gradients and moments are trees of tensors: lists, tuples
and dicts (in sorted key order, as `jax.tree` flattens them).  Moments
are f32 whatever the parameter type; `AdamWState.step` is an int32
tensor, as in the reference, so a checkpoint of either package restores
in the other (`checkpoint/manager.py`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any
    v: Any


def tree_leaves(tree) -> list:
    """Leaves of a list / tuple / dict tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (and the same leaves of `rest`),
    keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def init(params: Any) -> AdamWState:
    f32 = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(f32, params), v=tree_map(f32, params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(x.to(torch.float32) ** 2) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _updater(cfg: AdamWConfig, grads: Any, state: AdamWState):
    """(the leaf update (p, g, m, v) -> (p', m', v'), the new step, the
    metrics) of one AdamW step over `grads`."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mh = m2 / bc1
        vh = v2 / bc2
        delta = (mh / (torch.sqrt(vh) + cfg.eps)
                 + cfg.weight_decay * p.to(torch.float32))
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2

    return upd, step, {"grad_norm": gnorm, "lr": lr}


def apply(cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any
          ) -> tuple[Any, AdamWState, dict]:
    """One update.  Returns (new_params, new_state, metrics)."""
    upd, step, metrics = _updater(cfg, grads, state)
    out = tree_map(upd, params, grads, state.m, state.v)
    # `out` holds (p, m, v) triples at the leaves, where tree_map would
    # descend into them: pick each part through the params' structure
    new_p, new_m, new_v = (_select(params, out, i) for i in range(3))
    return new_p, AdamWState(step=step, m=new_m, v=new_v), metrics


def apply_(cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any
           ) -> tuple[AdamWState, dict]:
    """`apply` in place: the same numbers written into the leaves of
    `params` and of the state's moments, a leaf at a time, so an update
    holds one leaf's temporaries instead of a second copy of the
    parameters and moments.  Returns (the state with the new step and the
    same moment tensors, metrics)."""
    upd, step, metrics = _updater(cfg, grads, state)
    with torch.no_grad():
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v)):
            new_p, m2, v2 = upd(p, g, m, v)
            p.copy_(new_p)
            m.copy_(m2)
            v.copy_(v2)
    return AdamWState(step=step, m=state.m, v=state.v), metrics


def _select(like, tree, i):
    """Part `i` of the triples at the leaves of `like`'s structure."""
    if isinstance(like, dict):
        return {k: _select(like[k], tree[k], i) for k in like}
    if isinstance(like, (list, tuple)):
        out = [_select(x, tree[j], i) for j, x in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    return tree[i]
