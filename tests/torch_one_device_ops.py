"""The aten ops the port issues on one device, recorded by a dispatch mode.

`record()` runs, for each family's SMOKE config on the CPU, one
`make_train_step` step, one `forward_prefill`, one `forward_decode` and
one `Server` request (a prompt of 6 tokens, 3 new ones), each from
seeded weights and tokens, and returns {case: [op name, ...]} in issue
order.  The train step keeps every activation (`remat_policy`
"everything", and every fixed region of the hybrid and audio families
too: `no_remat`), which is what the port did before it rematerialised.
It calls only entry points whose one-device signatures predate the
port's mesh layer, so it runs on a checkout from before that layer as
well:

    PYTHONPATH=src python tests/torch_one_device_ops.py OUT.json

writes the record (op names stored once, each case as indexes into
them).  tests/data/torch_one_device_ops.json is that record, made at
commit 2d44687 (the port before the mesh layer);
tests/test_torch_mesh_train.py holds the current ops to it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

FAMILIES = ("granite-3-2b", "granite-moe-1b-a400m", "mamba2-130m",
            "zamba2-2.7b", "whisper-tiny", "phi-3-vision-4.2b")
B, S, CACHE = 2, 16, 32


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def ops_of(fn) -> list:
    """The aten ops `fn()` issues, in order."""
    mode = _Ops()
    with mode:
        fn()
    return mode.ops


@contextlib.contextmanager
def no_remat():
    """Every rematerialised region of `forward_train` keeps its
    activations: each policy of `models.transformer.REMAT_POLICIES` runs
    as "everything" (a tree without the table is left as it is)."""
    from repro_torch.models import transformer as T

    table = getattr(T, "REMAT_POLICIES", {})
    saved = dict(table)
    table.update({k: table["everything"] for k in table})
    try:
        yield
    finally:
        table.update(saved)


def _batch(cfg, rng) -> dict:
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": torch.tensor(toks[:, :-1]),
             "labels": torch.tensor(toks[:, 1:])}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.tensor(rng.normal(
            0, 1, (B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.tensor(rng.normal(
            0, 1, (B, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    return batch


def record() -> dict:
    from repro_torch.configs import registry as R
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.serve.server import Request, Server

    out = {}
    for name in FAMILIES:
        cfg = R.get_arch(name, smoke=True)
        rng = np.random.default_rng(0)
        batch = _batch(cfg, rng)

        def model():
            return T.init_model(cfg, torch.Generator().manual_seed(0))

        params = model()
        opt = adamw.init(dict(params.named_parameters()))
        step = ST.make_train_step(
            dataclasses.replace(cfg, remat_policy="everything"),
            adamw.AdamWConfig())
        with no_remat():
            out[f"{name}/train_step"] = ops_of(
                lambda: step(params, opt, batch))
        params = model()
        cache = CACHE + (cfg.n_patches if cfg.family == "vlm" else 0)
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        out[f"{name}/prefill"] = ops_of(
            lambda: T.forward_prefill(params, cfg, prompt, cache))
        _, state = T.forward_prefill(params, cfg, prompt, cache)
        tok = batch["tokens"][:, :1]
        out[f"{name}/decode"] = ops_of(
            lambda: T.forward_decode(params, cfg, state, tok))
        server = Server(cfg, params, device="cpu", batch_slots=1,
                        cache_len=cache)
        server.submit(Request(uid=0, prompt=rng.integers(
            0, cfg.vocab, 6).astype(np.int32), max_new_tokens=3))
        out[f"{name}/server"] = ops_of(server.run)
    return out


def pack(cases: dict) -> dict:
    names = sorted({op for ops in cases.values() for op in ops})
    index = {op: i for i, op in enumerate(names)}
    return {"names": names,
            "cases": {k: [index[op] for op in ops] for k, ops in cases.items()}}


def unpack(record_: dict) -> dict:
    names = record_["names"]
    return {k: [names[i] for i in ops] for k, ops in record_["cases"].items()}


if __name__ == "__main__":
    with open(sys.argv[1], "w") as f:
        json.dump(pack(record()), f, separators=(",", ":"))
