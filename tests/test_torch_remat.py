"""Rematerialisation in the port's LM training (`models.transformer`
`REMAT_POLICIES`, the reference's `remat_policy`), on the CPU at SMOKE
sizes in f32.

* For all six families, `forward_train`'s loss and every gradient with
  the rematerialised regions ("nothing", "dots"; the hybrid's groups and
  the audio blocks always save nothing) are bitwise those of keeping
  every activation (`remat_policy` "everything", every fixed region run
  plainly too: tests/torch_one_device_ops.py `no_remat`).  An unknown
  policy raises where the reference reads it (dense, vlm, moe, ssm).
* The region really runs again in the backward: the flash route's
  autograd.Function is called twice a layer (its kernel forward and the
  recompute), "dots" recomputes the batched products but no 2-D product.
* `trace_analysis.CostMode` of one dense `make_train_step` step: at
  "nothing" the FLOPs exceed "everything"'s by exactly the blocks'
  forward products less each block's last (`mlp_wo`, whose output its
  backward does not read: `torch.utils.checkpoint` stops the recompute
  after the last tensor the backward reads, as XLA drops dead code from
  the reference's); "dots" exceeds it by the blocks' batched products
  alone.  Temp bytes: "nothing" < "dots" < "everything".
The meshed steps at each policy are held in
tests/test_torch_mesh_train.py (`test_mesh_remat_is_bitwise_keeping_everything`,
on the gloo ranks that file spawns once; its train cases run every
family at the default, "nothing").
"""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry as TR
from repro_torch.distributed import trace_analysis as TTA
from repro_torch.launch import steps as TST
from repro_torch.models import attention as TATT
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TA

sys.path.insert(0, str(Path(__file__).parent))
from torch_one_device_ops import no_remat, ops_of  # noqa: E402

OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
# family -> (arch, text tokens): tests/test_torch_lm_train.py's (dense at
# 256 takes the flash route)
FAMILIES = {"dense": ("granite-3-2b", 256), "vlm": ("phi-3-vision-4.2b", 24),
            "moe": ("granite-moe-1b-a400m", 32), "ssm": ("mamba2-130m", 24),
            "hybrid": ("zamba2-2.7b", 16), "audio": ("whisper-tiny", 16)}
REMAT = ("nothing", "dots")


def _cfg(arch, **kw):
    return dataclasses.replace(TR.get_arch(arch, smoke=True),
                               dtype=torch.float32, **kw)


def _batch(cfg, b, s, seed=1) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": torch.tensor(toks[:, :-1]),
           "labels": torch.tensor(toks[:, 1:])}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.tensor(rng.normal(
            0, 1, (b, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        out["frames"] = torch.tensor(rng.normal(
            0, 1, (b, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    return out


def _loss_and_grads(family, policy):
    arch, s = FAMILIES[family]
    cfg = _cfg(arch, remat_policy=policy)
    model = TT.init_model(cfg, torch.Generator().manual_seed(0))
    named = dict(model.named_parameters())
    loss = TT.forward_train(model, cfg, _batch(cfg, 2, s))
    return loss.detach(), dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


@functools.lru_cache(maxsize=None)
def _kept(family):
    with no_remat():
        return _loss_and_grads(family, "everything")


@pytest.mark.parametrize("policy", REMAT)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_is_bitwise_keeping_everything(family, policy):
    loss, grads = _loss_and_grads(family, policy)
    want_loss, want = _kept(family)
    assert torch.equal(loss, want_loss), (float(loss), float(want_loss))
    assert grads.keys() == want.keys()
    bad = [n for n in want if not torch.equal(grads[n], want[n])]
    assert not bad, bad


@pytest.mark.parametrize("family", ["dense", "vlm", "moe", "ssm"])
def test_unknown_policy_raises(family):
    with pytest.raises(KeyError, match="offload"):
        _loss_and_grads(family, "offload")


def _flash_calls(policy) -> int:
    calls = [0]
    plain = TATT.flash_attention

    def spy(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    TATT.flash_attention = spy
    try:
        _loss_and_grads("dense", policy)
    finally:
        TATT.flash_attention = plain
    return calls[0]


def _step_ops(policy) -> list:
    arch, s = FAMILIES["dense"]
    cfg = _cfg(arch, remat_policy=policy)
    model = TT.init_model(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg, 2, 32)
    return ops_of(lambda: TT.forward_train(model, cfg, batch).backward())


def test_the_regions_run_again_in_the_backward():
    """The flash route (dense at S 256): one call a layer keeping
    everything, two at "nothing" and "dots" (the autograd.Function's
    forward runs again).  At S 32 (plain SDPA) "dots" issues as many 2-D
    products as keeping everything and more batched ones."""
    layers = _cfg(FAMILIES["dense"][0]).n_layers
    assert _flash_calls("everything") == layers
    assert _flash_calls("nothing") == _flash_calls("dots") == 2 * layers
    ops = {p: _step_ops(p) for p in ("everything", "nothing", "dots")}

    def count(p, name):
        return ops[p].count(f"aten.{name}.default")

    assert count("dots", "mm") == count("everything", "mm") < count(
        "nothing", "mm")
    assert count("dots", "bmm") == count("nothing", "bmm") > count(
        "everything", "bmm")


def _step_costs(cfg, batch) -> TTA.TraceCosts:
    model = TT.init_model(cfg, torch.Generator().manual_seed(0))
    opt = TA.init(dict(model.named_parameters()))
    step = TST.make_train_step(cfg, TA.AdamWConfig(**OPT))
    return TTA.trace(lambda: step(model, opt, batch))


def _block_flops(cfg, batch) -> tuple:
    """(FLOPs of the blocks' forward, of their batched products alone)."""
    model = TT.init_model(cfg, torch.Generator().manual_seed(0))
    mode = TTA.CostMode()
    bmm = [0.0]

    class Batched(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func._overloadpacket.__name__ in ("bmm", "baddbmm"):
                bmm[0] += TTA._matmul_flops("bmm", args, out)
            return out

    with torch.no_grad():
        x = TT.embed_tokens(model, cfg, batch["tokens"])
        with mode, Batched():
            for block in model.blocks:
                x, _ = TT._attn_mlp_block(x, block, cfg)
    return mode.costs().flops, bmm[0]


def test_cost_mode_counts_the_recompute():
    arch, s = FAMILIES["dense"]
    cfg = _cfg(arch)
    batch = _batch(cfg, 2, s)
    costs = {p: _step_costs(dataclasses.replace(cfg, remat_policy=p), batch)
             for p in ("everything", "nothing", "dots")}
    blocks, batched = _block_flops(cfg, batch)
    b, d, ff = 2, cfg.d_model, cfg.d_ff
    last = cfg.n_layers * 2.0 * b * s * ff * d         # each block's mlp_wo
    assert costs["nothing"].flops - costs["everything"].flops == blocks - last
    assert costs["dots"].flops - costs["everything"].flops == batched > 0
    temp = {p: c.temp_bytes for p, c in costs.items()}
    assert temp["nothing"] < temp["dots"] < temp["everything"], temp
