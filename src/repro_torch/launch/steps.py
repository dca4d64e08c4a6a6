"""Step builders: the LM train step on one card.

Port of `repro.launch.steps`'s `make_train_step`.  The reference's mesh,
sharding rules and residual `constraint` place the step on a device mesh;
on one card they have no counterpart.  Its prefill and decode steps are
`models.transformer.forward_prefill` / `forward_decode`, which
`serve.server.Server` calls directly.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import ArchConfig
from repro_torch.optim import adamw


def make_train_step(cfg: ArchConfig,
                    opt_cfg: adamw.AdamWConfig | None = None):
    """`train_step(params, opt, batch) -> (params, opt, metrics)`.

    `params` is a `Transformer`, `opt` an `AdamWState` whose moments are
    dicts keyed by the model's parameter names
    (`adamw.init(dict(model.named_parameters()))`).  One step: the loss
    of `forward_train` and its gradients by autograd, then AdamW
    (`adamw.apply_`), which writes the new parameters and moments in
    place; the returned `params` is the same module.  metrics: "loss",
    "grad_norm", "lr" (0-d tensors on the card, not synchronised).
    """
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params: T.Transformer, opt: adamw.AdamWState,
                   batch: dict):
        named = dict(params.named_parameters())
        loss = T.forward_train(params, cfg, batch)
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
        opt, metrics = adamw.apply_(opt_cfg, grads, opt, named)
        return params, opt, {"loss": loss.detach(), **metrics}

    return train_step
