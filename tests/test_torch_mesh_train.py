"""LM training on a DeviceMesh against the JAX package, on the CPU.

gloo ranks spawned from the test (tests/torch_mesh_ranks.py) mesh
themselves (`launch/mesh.py` `make_host_mesh`) at world 2 (data 1 x
model 2) and world 4 (data 2 x model 2) and train each family's SMOKE
config in f32 for 3 steps with `make_train_step(mesh=...)`, from the
reference's initial weights carried across by `convert_lm`.  Held:

* each step's loss within 1e-5 relative of the reference's
  `make_train_step` on the same weights and batches, and of the port's
  one-device step; every rank reports the same loss and grad_norm; the
  parameters are DTensors laid out by their specs; at world 2 the dense
  step at the remat policies "nothing" (the default) and "dots" is
  bitwise the step keeping every activation;
* the pure-FSDP rules (`FSDP_RULES`) at world 4, the same losses;
* at world 2, the loss of logits whose vocab (255) the "model" axis
  does not divide, split unevenly and vocab-parallel, and its gradient
  against one device;
* a prefill and three greedy decode steps at world 4 against one
  device within 1e-5 of the logits' largest magnitude: the kv heads
  sharded on "model", and (one kv head) the cache sharded over its
  positions, read flash-decoding style;
* the vocab-parallel lookup at world 4 bitwise the one-device lookup,
  rows and gradient, on both of its routes (a decode step's tokens move
  their rows, a prompt's gather the table's d-shard);
* `Trainer(mesh=...)`: a checkpoint written at world 4 restores at world
  2, and the resumed run's loss and parameters are the uninterrupted
  one-device run's;
* `make_train_step` with `mesh=None` (keeping every activation:
  `remat_policy` "everything", tests/torch_one_device_ops.py
  `no_remat`), the forwards with `constraint=None` and `Server` issue
  the aten ops the port issued before its mesh layer (a record in
  tests/data), but for the embedding's; `embed_tokens` (F.embedding) is
  bitwise the old row index, values and gradients.  The steps at the
  remat default are held in tests/test_torch_remat.py.
"""
import dataclasses
import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.convert import convert_lm
from repro_torch.launch import steps as TST
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TA
from repro_torch.train.trainer import Trainer, TrainJobConfig

sys.path.insert(0, str(Path(__file__).parent))
import torch_one_device_ops as one_device_ops  # noqa: E402
from torch_mesh_ranks import spawn_mesh_ranks  # noqa: E402

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as RR  # noqa: E402
from repro.launch import steps as RST  # noqa: E402
from repro.launch.mesh import make_host_mesh as r_host_mesh  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402

LOSS_REL = 1e-5
LOGIT_REL = 1e-5          # of the logits' largest magnitude
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
B = 4
# family -> (arch, text tokens); the hybrid at 16, where its SMOKE
# gradients are well conditioned in f32 (tests/test_torch_lm_train.py)
FAMILIES = {"dense": ("granite-3-2b", 32), "vlm": ("phi-3-vision-4.2b", 24),
            "moe": ("granite-moe-1b-a400m", 32), "ssm": ("mamba2-130m", 24),
            "hybrid": ("zamba2-2.7b", 16), "audio": ("whisper-tiny", 16)}
DECODE = {"kv_heads": {}, "kv_positions": {"n_kv_heads": 1}}
# the dense case again at the other remat policies (the default,
# "nothing", is the train case itself)
REMAT = ("dots", "everything")
CKPT = dict(arch="granite-3-2b", batch=4, seq=16, seed=5)


def _cfgs(name, **kw):
    return (dataclasses.replace(RR.get_arch(name, smoke=True),
                                dtype=jnp.float32, **kw),
            dataclasses.replace(TR.get_arch(name, smoke=True),
                                dtype=torch.float32, **kw))


def _params(name, **kw):
    rcfg, tcfg = _cfgs(name, **kw)
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(0))
    model = convert_lm(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return params, {n: p.detach().clone()
                    for n, p in model.named_parameters()}


def _batches(cfg, s, n=3, seed=1) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab, (B, s + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "vlm":
            b["patch_embeds"] = rng.normal(
                0, 1, (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            b["frames"] = rng.normal(
                0, 1, (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _train_cases():
    cases = {}
    for fam, (arch, s) in FAMILIES.items():
        _, params = _params(arch)
        cases[fam] = dict(kind="train", arch=arch, params=params,
                          batches=[_torch(b) for b in _batches(
                              _cfgs(arch)[1], s)], opt=OPT,
                          return_params=fam == "dense")
    return cases


# logits whose vocab the 2-way "model" axis does not divide
ODD_VOCAB = 255


def _vocab_loss_case():
    g = torch.Generator().manual_seed(3)
    return dict(kind="vocab_loss",
                logits=torch.randn(B, 8, ODD_VOCAB, generator=g),
                labels=torch.randint(0, ODD_VOCAB, (B, 8), generator=g))


def _decode_case(**kw):
    _, params = _params("granite-3-2b", **kw)
    toks = np.random.default_rng(9).integers(0, 256, (B, 12))
    return dict(kind="decode", arch="granite-3-2b", cfg=kw, params=params,
                batch={"tokens": torch.tensor(toks, dtype=torch.int32)},
                cache_len=16, steps=3)


# token batches of the lookup at world 4 (the batch on "data"): a decode
# step's (2 tokens a device, fewer than the 128 vocab rows a device
# holds: the rows move) and a prompt's (2 x 64 a device: the table's
# d-shard is gathered)
EMBED_TOKENS = {"rows": (B, 1), "table": (B, 64)}


@functools.cache
def _embed_case() -> dict:
    _, params = _params("granite-3-2b")
    rng = np.random.default_rng(4)
    return dict(kind="embed_routes", arch="granite-3-2b", params=params,
                tokens=[torch.tensor(rng.integers(0, 256, shape),
                                     dtype=torch.int32)
                        for shape in EMBED_TOKENS.values()])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' ranks, spawned once: world 4 trains every family,
    FSDP, serves, and writes a checkpoint; world 2 trains every family
    and resumes from it."""
    cases = _train_cases()
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    four = [*cases.values(),
            dict(cases["dense"], fsdp=True),
            *(_decode_case(**kw) for kw in DECODE.values()),
            _embed_case(),
            dict(kind="checkpoint", steps=2, ckpt_dir=ckpt, **CKPT)]
    w4 = spawn_mesh_ranks(tmp_path_factory.mktemp("w4"), 4, 2, four)
    remat = [dict(cases["dense"], cfg={"remat_policy": p},
                  return_params=True) for p in REMAT]
    two = [*cases.values(), *remat, _vocab_loss_case(),
           dict(kind="checkpoint", steps=3, ckpt_dir=ckpt, **CKPT)]
    w2 = spawn_mesh_ranks(tmp_path_factory.mktemp("w2"), 2, 2, two)
    n = len(FAMILIES)
    return {"cases": cases, "ckpt": ckpt,
            4: {"train": {f: [r[i] for r in w4] for i, f in enumerate(cases)},
                "fsdp": [r[n] for r in w4],
                "decode": {k: [r[n + 1 + i] for r in w4]
                           for i, k in enumerate(DECODE)},
                "embed": [r[-2] for r in w4],
                "checkpoint": [r[-1] for r in w4]},
            2: {"train": {f: [r[i] for r in w2] for i, f in enumerate(cases)},
                "remat": {p: [r[n + i] for r in w2]
                          for i, p in enumerate(REMAT)},
                "vocab_loss": [r[n + len(REMAT)] for r in w2],
                "checkpoint": [r[-1] for r in w2]}}


@functools.lru_cache(maxsize=None)
def _reference_losses(arch, s) -> tuple:
    rcfg, _ = _cfgs(arch)
    params, _ = _params(arch)
    mesh = r_host_mesh()
    step = jax.jit(RST.make_train_step(rcfg, mesh, RA.AdamWConfig(**OPT)))
    opt = RA.init(params)
    losses = []
    with mesh:
        for b in _batches(rcfg, s):
            params, opt, m = step(params, opt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    return tuple(losses)


@functools.lru_cache(maxsize=None)
def _one_device_family(family: str) -> tuple:
    arch, s = FAMILIES[family]
    _, params = _params(arch)
    return _one_device_losses(dict(arch=arch, params=params, batches=[
        _torch(b) for b in _batches(_cfgs(arch)[1], s)]))


def _one_device_losses(case) -> tuple:
    cfg = _cfgs(case["arch"], **case.get("cfg", {}))[1]
    model = TT.model_from(cfg, {k: v.clone()
                                for k, v in case["params"].items()})
    opt = TA.init(dict(model.named_parameters()))
    step = TST.make_train_step(cfg, TA.AdamWConfig(**OPT))
    losses = []
    for b in case["batches"]:
        model, opt, m = step(model, opt, b)
        losses.append(float(m["loss"]))
    return tuple(losses)


def _close(got, want, rel=LOSS_REL):
    return all(abs(g - w) <= rel * abs(w) for g, w in zip(got, want)) \
        and len(got) == len(want)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_mesh_training_matches_reference(runs, family, world):
    ranks = runs[world]["train"][family]
    want_ref = _reference_losses(*FAMILIES[family])
    want_one = _one_device_family(family)
    got = ranks[0]["loss"]
    assert all(r["loss"] == got and r["grad_norm"] == ranks[0]["grad_norm"]
               for r in ranks)
    assert _close(got, want_ref), (got, want_ref)
    assert _close(got, want_one), (got, want_one)
    placements = ranks[0]["placements"]
    # ("vocab", "embed") on (data, model): the embed dim on "data" (of
    # one device at world 2), the vocab on "model"
    assert placements["embed"] == ("Shard(1)", "Shard(0)")
    assert any("Shard" in str(p) for n, p in placements.items()
               if n.startswith("blocks.0."))


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_mesh_remat_is_bitwise_keeping_everything(runs, policy):
    """The dense case on the world-2 mesh at `policy` ("nothing": the
    train case itself): loss, grad_norm and updated parameters bitwise
    the same mesh step keeping every activation, and the losses within
    LOSS_REL of the one-device step at the same policy."""
    ranks = (runs[2]["train"]["dense"] if policy == "nothing"
             else runs[2]["remat"][policy])
    kept = runs[2]["remat"]["everything"][0]
    got = ranks[0]
    assert all(r["loss"] == got["loss"] for r in ranks)
    assert got["loss"] == kept["loss"]
    assert got["grad_norm"] == kept["grad_norm"]
    assert got["params"].keys() == kept["params"].keys()
    assert all(torch.equal(got["params"][n], kept["params"][n])
               for n in kept["params"])
    case = dict(runs["cases"]["dense"], cfg={"remat_policy": policy})
    want = _one_device_losses(case)
    assert _close(got["loss"], want), (got["loss"], want)


def test_loss_of_a_vocab_the_model_axis_does_not_divide(runs):
    """Logits (B, 8, 255) on data 1 x model 2: the loss splits the vocab
    unevenly (128 and 127 columns, as DTensor chunks it) and takes the
    vocab-parallel form, no rank holding a full row; the loss and the
    gradient are the one-device ones."""
    case = _vocab_loss_case()
    logits = case["logits"].clone().requires_grad_(True)
    loss = TC.cross_entropy_loss(logits, case["labels"])
    loss.backward()
    want = float(loss.detach())
    got = runs[2]["vocab_loss"]
    assert sorted(r["local_vocab"] for r in got) == [127, 128]
    for r in got:
        assert r["split"] and r["placements"][-1] == "Shard(dim=2)"
        assert abs(r["loss"] - want) <= LOSS_REL * abs(want)
        scale = float(logits.grad.abs().max())
        assert float((r["grad"] - logits.grad).abs().max()) <= \
            LOGIT_REL * scale


def test_fsdp_rules_train_the_same(runs):
    ranks = runs[4]["fsdp"]
    want = _one_device_family("dense")
    assert _close(ranks[0]["loss"], want), (ranks[0]["loss"], want)
    # pure ZeRO-3: no parameter dim on "model" alone
    assert ranks[0]["placements"]["blocks.0.wq"] == ("Shard(0)",
                                                     "Shard(0)")


@pytest.mark.parametrize("layout", list(DECODE))
def test_mesh_prefill_and_decode_match_one_device(runs, layout):
    kw = DECODE[layout]
    case = _decode_case(**kw)
    cfg = _cfgs("granite-3-2b", **kw)[1]
    model = TT.model_from(cfg, case["params"])
    out, state = TT.forward_prefill(model, cfg, case["batch"],
                                    case["cache_len"])
    want = [out]
    for _ in range(case["steps"]):
        tok = want[-1].argmax(-1, keepdim=True).to(torch.int32)
        out, state = TT.forward_decode(model, cfg, state, tok)
        want.append(out)
    for r in runs[4]["decode"][layout]:
        assert len(r["logits"]) == len(want)
        for g, w in zip(r["logits"], want):
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= LOGIT_REL * scale


@pytest.mark.parametrize("route", list(EMBED_TOKENS))
def test_mesh_lookup_is_the_one_device_lookup_bitwise(runs, route):
    """The vocab-parallel lookup at world 4 (the table's vocab on
    "model", its d on "data"), rows and the table's gradient, on both
    routes: a decode step's tokens move their rows (no all-gather as
    large as the table's block of 128 vocab rows), a prompt's gather the
    table's d-shard (exactly that block)."""
    case = _embed_case()
    i = list(EMBED_TOKENS).index(route)
    cfg = _cfgs("granite-3-2b")[1]
    model = TT.model_from(cfg, case["params"])
    want = TT.embed_tokens(model, cfg, case["tokens"][i])
    (g_want,) = torch.autograd.grad(want.square().sum(), model.embed)
    block = cfg.vocab // 2 * cfg.d_model * 4
    for r in runs[4]["embed"]:
        got = r[i]
        assert torch.equal(got["rows"], want)
        assert torch.equal(got["grad"], g_want)
        assert (got["largest_gather"] < block if route == "rows"
                else got["largest_gather"] == block)


def test_checkpoint_at_world_4_restores_at_world_2(runs, tmp_path):
    """2 steps at world 4 (saved), then world 2 resumes for step 3: its
    loss and final parameters are the uninterrupted one-device run's."""
    cfg = _cfgs(CKPT["arch"])[1]
    job = TrainJobConfig(batch=CKPT["batch"], seq_len=CKPT["seq"],
                         num_steps=3, save_every=3,
                         ckpt_dir=str(tmp_path / "one"), seed=CKPT["seed"])
    losses = []
    state = Trainer(cfg, job, device="cpu").run(
        on_metrics=lambda s, m, dt: losses.append(float(m["loss"])))
    four, two = runs[4]["checkpoint"], runs[2]["checkpoint"]
    assert all(r["step"] == 2 for r in four) and all(r["step"] == 3
                                                     for r in two)
    assert _close(four[0]["loss"], losses[:2])
    assert len(two[0]["loss"]) == 1 and _close(two[0]["loss"], losses[2:])
    for name, p in state["params"].named_parameters():
        got = two[0]["params"][name]
        assert float((got - p.detach()).abs().max()) <= 1e-5 * max(
            float(p.abs().max()), 1.0), name


# ---------------------------------------------------------------------------
# no mesh: the one-device ops
# ---------------------------------------------------------------------------

# The port's one-device ops before its mesh layer, recorded by
# tests/torch_one_device_ops.py at commit 2d44687; `embed_tokens` has
# since become `F.embedding` (bitwise the row index it replaced), whose
# forward and backward ops stand for the index's.  The ssm and hybrid
# cases since carry the SSD scan's mask taken before its exp (an
# overflow above the diagonal made the gradient NaN): where(m, diff,
# -inf) then exp in place of exp then where(m, ., 0), the same count of
# ops with `full` for `zeros` and the backward's detach / mul moved.
PARENT_OPS = Path(__file__).parent / "data" / "torch_one_device_ops.json"
EMBEDDING_WAS = {"aten.embedding.default": ["aten.index.Tensor"],
                 "aten.embedding_dense_backward.default": [
                     "aten.new_zeros.default", "aten.index_put.default"]}


@functools.lru_cache(maxsize=None)
def _ops_now() -> dict:
    return one_device_ops.record()


def _as_before(ops: list) -> list:
    return [was for op in ops for was in EMBEDDING_WAS.get(op, [op])]


@pytest.mark.parametrize("arch", one_device_ops.FAMILIES)
def test_no_mesh_issues_the_one_device_ops(arch):
    """With `mesh=None` and `constraint=None`, `make_train_step` keeping
    every activation, `forward_prefill`, `forward_decode` and `Server`
    issue the aten ops the port issued before its mesh layer, op for op,
    but for the embedding's."""
    before = one_device_ops.unpack(json.loads(PARENT_OPS.read_text()))
    now = _ops_now()
    cases = [k for k in before if k.startswith(f"{arch}/")]
    assert len(cases) == 4
    for case in cases:
        assert _as_before(now[case]) == before[case], case
        assert "aten.embedding.default" in now[case], case
        assert not any("c10d" in op for op in now[case]), case


def test_embed_tokens_is_the_row_index_bitwise():
    cfg = _cfgs("granite-3-2b")[1]
    model = TT.init_model(cfg, torch.Generator().manual_seed(0))
    tokens = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 40)))
    got = TT.embed_tokens(model, cfg, tokens)
    (g_got,) = torch.autograd.grad(got.square().sum(), model.embed)
    want = model.embed.to(cfg.dtype)[tokens.long()]
    (g_want,) = torch.autograd.grad(want.square().sum(), model.embed)
    assert torch.equal(got, want) and torch.equal(g_got, g_want)
