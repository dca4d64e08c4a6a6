"""Batched LM serving: left-padded batched prefill, then greedy one-token
decode against a static KV cache, on one device or on a device mesh.

Port of `repro.serve.server`.  The reference runs the prefill and decode
steps of `launch.steps` on its mesh; so does this server, with
`launch/steps.py` `make_prefill_step` / `make_decode_step`.  Without a
mesh they are the eager one-device `forward_prefill` / `forward_decode`
on `device`, where the prompts go.  On a `DeviceMesh`
(`launch/mesh.py` `make_host_mesh`) the server lays the parameters and
C3 buffers out by `launch.steps.shard_serving_params`, the left-padded
prompts and the step tokens go on the batch axes, the prefill's caches
come out laid out by `decode_state_specs` (the parameters and the
residual by the sharding `rules`), and `sample` gets the full
logits, a plain tensor the same on every rank, so every rank returns
the same requests.  With `cfg.quant_serving` the decode step takes
`quant.lm_quant.make_param_transform(cfg.dtype)` and so does the
prefill, which then, as the reference's, takes no residual constraint;
the model's C3-quantized 2-D weights run on the `codebook_matmul`
kernel, on each rank's shards on a mesh.  The audio family's encoder
gets zero frames and the vlm family zero patch embeddings (the
reference's stub frontends); a vlm `cache_len` must hold the n_patches
patch positions beside the prompt and the new tokens, and prefill raises
`ValueError` when patches and prompt do not fit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.models.common import ArchConfig
from repro_torch.quant.lm_quant import make_param_transform


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


def _quant_prefill(cfg: ArchConfig, mesh, cache_len: int, pt: Callable):
    """The reference's C3 prefill: `forward_prefill` through the parameter
    transform, with no residual constraint; on a mesh the batch on the
    batch axes."""
    def prefill_step(params: T.Transformer, batch: dict):
        if mesh is None:
            return T.forward_prefill(params, cfg, batch, cache_len,
                                     param_transform=pt)
        from torch.distributed.tensor.experimental import (
            implicit_replication)

        with implicit_replication():
            logits, state = T.forward_prefill(
                params, cfg, ST.shard_batch(batch, mesh), cache_len,
                param_transform=pt)
        return logits, ST.lay_out_state(state, mesh)

    return prefill_step


class Server:
    """Fixed-slot batching over a single shared decode state."""

    def __init__(self, cfg: ArchConfig, params: T.Transformer, device=None,
                 batch_slots: int = 4, cache_len: int = 256, mesh=None,
                 rules: SH.ShardingRules = SH.ShardingRules()):
        if device is None and mesh is not None:
            device = mesh.device_type
        self.device = resolve_device(device)
        on = params.embed.device
        if on.type != self.device.type:
            raise ValueError(f"parameters lie on {on}, the server runs on "
                             f"{self.device}")
        if mesh is not None:
            params = ST.shard_serving_params(params, mesh, rules)
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.slots = batch_slots
        self.cache_len = cache_len
        if cfg.quant_serving:
            self.prefill = _quant_prefill(cfg, mesh, cache_len,
                                          make_param_transform(cfg.dtype))
        else:
            self.prefill = ST.make_prefill_step(cfg, mesh, cache_len,
                                                rules=rules)
        self.decode = ST.make_decode_step(cfg, mesh, rules)
        self.queue: list[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _prefill_batch(self, reqs: list[Request]):
        max_len = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), max_len), np.int32)
        for i, r in enumerate(reqs):
            toks[i, -len(r.prompt):] = r.prompt     # left-pad, no mask
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        if self.cfg.family == "audio":        # the stub frontend's frames
            batch["frames"] = torch.zeros(
                (len(reqs), self.cfg.enc_frames, self.cfg.d_model),
                dtype=torch.float32, device=self.device)
        if self.cfg.family == "vlm":          # the stub frontend's patches
            batch["patch_embeds"] = torch.zeros(
                (len(reqs), self.cfg.n_patches, self.cfg.d_model),
                dtype=torch.float32, device=self.device)
        return self.prefill(self.params, batch=batch)

    def run(self, sample: Callable | None = None, max_steps: int = 512
            ) -> list[Request]:
        """Drain the queue: group into one batch, prefill, decode to done.
        `sample` maps the full logits (B, V), a plain tensor, to tokens."""
        sample = sample or (lambda lg: torch.argmax(lg, dim=-1))
        finished: list[Request] = []
        while self.queue:
            batch_reqs = [self.queue.pop(0)
                          for _ in range(min(self.slots, len(self.queue)))]
            logits, state = self._prefill_batch(batch_reqs)
            next_tok = sample(SH.full(logits))
            for _ in range(max_steps):
                toks = np.asarray(torch.as_tensor(next_tok).cpu())
                for i, r in enumerate(batch_reqs):
                    if not r.done:
                        r.out_tokens.append(int(toks[i]))
                        if len(r.out_tokens) >= r.max_new_tokens:
                            r.done = True
                if all(r.done for r in batch_reqs):
                    break
                step_toks = torch.as_tensor(toks[:, None].astype(np.int32),
                                            device=self.device)
                logits, state = self.decode(self.params, state=state,
                                            tokens=step_toks)
                next_tok = sample(SH.full(logits))
            finished.extend(batch_reqs)
        return finished
