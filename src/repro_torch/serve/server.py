"""Batched LM serving: left-padded batched prefill, then greedy one-token
decode against a static KV cache.

Port of `repro.serve.server`.  The reference's `mesh` (sharding of the
jitted steps) has no counterpart on one card: it becomes `device`, where
the prompts go.  Prefill and decode are the eager `forward_prefill` /
`forward_decode` of `models.transformer`; with `cfg.quant_serving` both
take `quant.lm_quant.make_param_transform(cfg.dtype)`, as the
reference's prefill and decode steps do, so the model's C3-quantized
2-D weights run on the `codebook_matmul` kernel.  The audio family's
encoder gets zero frames and the vlm family zero patch embeddings (the
reference's stub frontends); a vlm `cache_len` must hold the
n_patches patch positions beside the prompt and the new tokens, and
prefill raises `ValueError` when patches and prompt do not fit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
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


class Server:
    """Fixed-slot batching over a single shared decode state."""

    def __init__(self, cfg: ArchConfig, params: T.Transformer, device=None,
                 batch_slots: int = 4, cache_len: int = 256):
        self.device = resolve_device(device)
        on = params.embed.device
        if on.type != self.device.type:
            raise ValueError(f"parameters lie on {on}, the server runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.cache_len = cache_len
        pt = make_param_transform(cfg.dtype) if cfg.quant_serving else None
        self.prefill = functools.partial(T.forward_prefill, cfg=cfg,
                                         cache_len=cache_len,
                                         param_transform=pt)
        self.decode = functools.partial(T.forward_decode, cfg=cfg,
                                        param_transform=pt)
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
        """Drain the queue: group into one batch, prefill, decode to done."""
        sample = sample or (lambda lg: torch.argmax(lg, dim=-1))
        finished: list[Request] = []
        while self.queue:
            batch_reqs = [self.queue.pop(0)
                          for _ in range(min(self.slots, len(self.queue)))]
            logits, state = self._prefill_batch(batch_reqs)
            next_tok = sample(logits)
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
                next_tok = sample(logits)
            finished.extend(batch_reqs)
        return finished
