"""LM training on the port against the JAX package, on the CPU, in f32 at
SMOKE sizes.

* `forward_train`'s loss and gradients for the six families (dense at
  S = 256, on the port's flash route; vlm with patch embeddings, the loss
  on text positions; moe with its aux term; ssm; hybrid; audio), weights
  carried across by `convert_lm`, gradients mapped back by `lm_tree`;
* the flash route's `autograd.Function` against the reference's
  `_flash_core` (its Pallas kernel in interpret mode) and `jax.vjp`;
* `cross_entropy_loss`, `TokenStream` token for token, one
  `make_train_step` against the reference's `train_step`;
* `Trainer` runs and resumes, and checkpoints cross between the two
  packages' trainers in the reference's layout.

Both packages train at their remat default ("nothing": every block
recomputed in the backward; tests/test_torch_remat.py holds the port's
policies to each other).  Tolerances: the loss within 1e-5 relative;
each gradient leaf within 1e-4 of the leaf's largest magnitude.
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.convert import convert_lm, lm_tree, load_lm_tree
from repro_torch.data.synthetic import TokenStream
from repro_torch.distributed.elastic import FaultTolerantLoop, StragglerPolicy
from repro_torch.launch import steps as TST
from repro_torch.models import attention as TATT
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TA
from repro_torch.train.trainer import Trainer, TrainJobConfig

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as RR  # noqa: E402
from repro.data.synthetic import TokenStream as RTokenStream  # noqa: E402
from repro.models import attention as RATT  # noqa: E402
from repro.models import common as RC  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402

LOSS_REL = 1e-5
GRAD_REL = 1e-4      # of each leaf's largest magnitude
F32_TOL = 2e-5       # flash: online against one-pass softmax

# family -> (arch, text tokens).  Dense at 256 takes the flash route.  The
# hybrid runs at 16: at 24 and 32 its SMOKE gradients are ill-conditioned
# in f32 (weights scaled by 1 + 1.2e-7 N(0, 1), about an ulp, move them by
# 1.1e-4 to 5.3e-4 of a leaf's largest magnitude; at 16 by 1.3e-5), so no
# two f32 implementations agree there within GRAD_REL.  Its window (16)
# binds in `test_windowed_attention_gradients_match_reference`.
FAMILIES = {"dense": ("granite-3-2b", 256), "vlm": ("phi-3-vision-4.2b", 24),
            "moe": ("granite-moe-1b-a400m", 32), "ssm": ("mamba2-130m", 24),
            "hybrid": ("zamba2-2.7b", 16), "audio": ("whisper-tiny", 16)}


def _cfgs(name, **kw):
    return (dataclasses.replace(RR.get_arch(name, smoke=True),
                                dtype=jnp.float32, **kw),
            dataclasses.replace(TR.get_arch(name, smoke=True),
                                dtype=torch.float32, **kw))


def _setup(name, seed=0):
    rcfg, tcfg = _cfgs(name)
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(seed))
    model = convert_lm(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return rcfg, tcfg, params, model


def _train_batch(cfg, b, s, seed=1) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            0, 1, (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            0, 1, (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _assert_trees_close(got: dict, want: dict, rel: float, path=""):
    """Each leaf of `got` (tensors) within `rel` of `want`'s (arrays)
    largest magnitude."""
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], rel, f"{path}/{k}")
            continue
        g, w = got[k].detach().numpy(), np.asarray(want[k])
        assert g.shape == w.shape, (path, k)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= rel * scale, (
            f"{path}/{k}", float(np.abs(g - w).max()) / scale)


def _grads(model, cfg, batch):
    named = dict(model.named_parameters())
    loss = TT.forward_train(model, cfg, batch)
    return loss.detach(), lm_tree(dict(zip(named, torch.autograd.grad(
        loss, list(named.values())))))


# ---------------------------------------------------------------------------
# the loss and the flash route's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slab_rows", [None, 3], ids=["one-slab", "slabs"])
def test_row_terms_are_the_one_device_loss(monkeypatch, slab_rows):
    """The meshed loss's per-device terms (`common._RowTerms`): in one
    slab, the logsumexp, the label's logit and the bf16 gradient of a
    z-loss of them are bitwise the one-device chain's; in slabs of 3 rows
    (of 14), the same."""
    rng = np.random.default_rng(3)
    logits = torch.tensor(rng.normal(0, 3, (2, 7, 50)).astype(np.float32)
                          ).to(torch.bfloat16)
    labels = torch.tensor(rng.integers(0, 50, (2, 7)).astype(np.int32))
    if slab_rows:
        monkeypatch.setattr(TC, "ROW_SLAB_BYTES", 4 * 50 * slab_rows)

    def loss(lse, ll):
        return (lse - ll + 1e-4 * lse ** 2).mean()

    a = logits.clone().requires_grad_()
    got = TC._RowTerms.apply(a, labels)
    (g_got,) = torch.autograd.grad(loss(*got), a)
    b = logits.clone().requires_grad_()
    x = b.float()
    want = (torch.logsumexp(x, dim=-1),
            torch.gather(x, -1, labels.long()[..., None])[..., 0])
    (g_want,) = torch.autograd.grad(loss(*want), b)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert g_got.dtype == torch.bfloat16 and torch.equal(g_got, g_want)


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked"])
def test_cross_entropy_loss_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = RC.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = TC.cross_entropy_loss(torch.tensor(logits), torch.tensor(labels),
                                None if mask is None else torch.tensor(mask))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))
    if masked:     # an all-zero mask divides by one, as the reference
        zero = np.zeros_like(mask)
        assert float(TC.cross_entropy_loss(
            torch.tensor(logits), torch.tensor(labels),
            torch.tensor(zero))) == float(RC.cross_entropy_loss(
                jnp.asarray(logits), jnp.asarray(labels),
                jnp.asarray(zero))) == 0.0


@pytest.mark.parametrize("group", [1, 2])
def test_flash_core_matches_reference_custom_vjp(group):
    """The port's `_FlashCore` (the plain version forward here, the
    reference SDPA's exact gradient backward) against the reference's
    `_flash_core` (the Pallas kernel in interpret mode) and its custom
    VJP, on the same q, k, v and cotangent."""
    rng = np.random.default_rng(group)
    q, k, v = (rng.normal(0, 1, (1, 4, 256, 16)).astype(np.float32),
               *(rng.normal(0, 1, (1, 4 // group, 256, 16)).astype(
                   np.float32) for _ in range(2)))
    g = rng.normal(0, 1, q.shape).astype(np.float32)
    want, vjp = jax.vjp(RATT._flash_core, *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = TATT._FlashCore.apply(*leaves)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    got_grads = torch.autograd.grad(got, leaves, torch.tensor(g))
    for name, a, b in zip("qkv", got_grads, want_grads):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=GRAD_REL * np.abs(b).max(),
                                   err_msg=name)


def test_flash_route_is_differentiable():
    """attention_train at S = 256 takes the flash route with a grad-
    requiring input (it used to raise), and its gradients are the plain
    route's (the same layer with a window wider than the sequence, which
    computes the same function off the flash route)."""
    _, tcfg = _cfgs("granite-3-2b")
    rng = np.random.default_rng(3)
    d, h, kv, hd = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd
    p = {n: torch.tensor(rng.normal(0, 0.1, s).astype(np.float32),
                         requires_grad=True)
         for n, s in (("wq", (d, h * hd)), ("wk", (d, kv * hd)),
                      ("wv", (d, kv * hd)), ("wo", (h * hd, d)))}
    x = torch.tensor(rng.normal(0, 1, (2, 256, d)).astype(np.float32),
                     requires_grad=True)
    g = torch.tensor(rng.normal(0, 1, (2, 256, d)).astype(np.float32))
    calls = []
    taken = TATT._FlashCore.apply
    out = {}
    for cfg in (tcfg, dataclasses.replace(tcfg, sliding_window=512)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TATT._FlashCore, "apply",
                       lambda *a: calls.append(cfg) or taken(*a))
            y = TATT.attention_train(x, p, cfg)
        out[cfg.sliding_window] = torch.autograd.grad(
            (y * g).sum(), [x, *p.values()])
    assert calls == [tcfg]
    for a, b in zip(out[0], out[512]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=GRAD_REL * float(b.abs().max()))


def test_windowed_attention_gradients_match_reference():
    """The hybrid's sliding window (16) at S = 24, where it binds."""
    rcfg, tcfg = _cfgs("zamba2-2.7b")
    rng = np.random.default_rng(4)
    d = tcfg.d_model
    p = {n: rng.normal(0, 0.3, s).astype(np.float32)
         for n, s in (("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                      ("wo", (d, d)))}
    x = rng.normal(0, 1, (2, 24, d)).astype(np.float32)
    g = rng.normal(0, 1, (2, 24, d)).astype(np.float32)
    _, (want_x, want_p) = jax.value_and_grad(
        lambda x, p: jnp.sum(RATT.attention_train(x, p, rcfg) * g),
        argnums=(0, 1))(jnp.asarray(x), p)
    xt = torch.tensor(x, requires_grad=True)
    pt = {k: torch.tensor(a, requires_grad=True) for k, a in p.items()}
    (TATT.attention_train(xt, pt, tcfg) * torch.tensor(g)).sum().backward()
    _assert_trees_close({"x": xt.grad, **{k: t.grad for k, t in pt.items()}},
                        {"x": want_x, **want_p}, GRAD_REL)


# ---------------------------------------------------------------------------
# forward_train, six families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_train_matches_reference(family):
    name, s = FAMILIES[family]
    rcfg, tcfg, params, model = _setup(name)
    assert tcfg.family == family
    batch = _train_batch(tcfg, 2, s)
    if family == "dense":
        assert TATT._flash_ok(tcfg, s)
    want, want_g = jax.value_and_grad(
        lambda p: RT.forward_train(p, rcfg, _jax(batch)))(params)
    got, got_g = _grads(model, tcfg, _torch(batch))
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))
    _assert_trees_close(got_g, jax.tree.map(np.asarray, want_g), GRAD_REL)


def test_vlm_loss_is_on_text_positions():
    """With patch embeddings the labels cover the text only; without
    them the model is the dense one over the text."""
    _, tcfg, _, model = _setup("phi-3-vision-4.2b")
    batch = _torch(_train_batch(tcfg, 2, 12))
    with_patches = TT.forward_train(model, tcfg, batch)
    batch.pop("patch_embeds")
    text_only = TT.forward_train(model, tcfg, batch)
    assert bool(torch.isfinite(with_patches)) and float(
        with_patches) != float(text_only)
    dense = TT.Transformer(dataclasses.replace(tcfg, family="dense"),
                           model.embed, model.unembed, model.final_norm,
                           [b.leaves() for b in model.blocks])
    assert float(TT.forward_train(dense, dense.cfg, batch)) == float(
        text_only)


# ---------------------------------------------------------------------------
# data, the train step, the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 1), (3, 17), (11, 5000)])
@pytest.mark.parametrize("vocab,seq,batch", [(512, 64, 8), (49155, 128, 2),
                                             (256, 16, 3)])
def test_token_stream_matches_reference_token_for_token(seed, step, vocab,
                                                        seq, batch):
    want = RTokenStream(vocab, seq, batch, seed).batch_at(step)
    got = TokenStream(vocab, seq, batch, seed).batch_at(step, device="cpu")
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_token_stream_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenStream(256, 16, 2).batch_at(0)


def _opt_tree(opt) -> dict:
    return {"step": opt.step, "m": lm_tree(opt.m), "v": lm_tree(opt.v)}


def test_make_train_step_matches_reference():
    """One step of each package's train step from the same weights and
    batch: loss, grad_norm and lr, the params and both moments.  The
    first AdamW step moves an element by lr·g/(|g| + eps), whose sign
    follows g's: elements whose gradient is within the frameworks'
    rounding of 0 may move apart by up to 2·lr."""
    from repro.launch import steps as RST
    from repro.launch.mesh import make_host_mesh

    rcfg, tcfg, params, model = _setup("granite-3-2b")
    ropt_cfg = RA.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    topt_cfg = TA.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    batch = _train_batch(tcfg, 2, 32)
    mesh = make_host_mesh()
    step = jax.jit(RST.make_train_step(rcfg, mesh, ropt_cfg))
    with mesh:
        want_p, want_opt, want_m = step(params, RA.init(params), _jax(batch))
    named = dict(model.named_parameters())
    opt = TA.init(named)
    got_model, opt, got_m = TST.make_train_step(tcfg, topt_cfg)(
        model, opt, _torch(batch))
    assert got_model is model and int(opt.step) == int(want_opt.step) == 1
    for key, rel in (("loss", LOSS_REL), ("grad_norm", 1e-5), ("lr", 1e-7)):
        assert abs(float(got_m[key]) - float(want_m[key])) <= rel * abs(
            float(want_m[key])), key
    lr = float(want_m["lr"])
    got_p = lm_tree(dict(model.named_parameters()))
    want_p = jax.tree.map(np.asarray, want_p)
    moved = jax.tree.map(lambda a, b: np.abs(np.asarray(a) - b), params,
                         want_p)
    assert max(float(x.max()) for x in jax.tree.leaves(moved)) > 0.5 * lr
    flat_got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got_p))
    for g, w in zip(flat_got, jax.tree.leaves(want_p)):
        assert float(np.abs(g - w).max()) <= 2 * lr
        # all but the elements whose sign of g is in doubt agree closely
        assert np.mean(np.abs(g - w) > 1e-3 * lr) < 1e-3
    _assert_trees_close(lm_tree(opt.m), jax.tree.map(np.asarray, want_opt.m),
                        GRAD_REL)
    _assert_trees_close(lm_tree(opt.v), jax.tree.map(np.asarray, want_opt.v),
                        2 * GRAD_REL)


def test_adamw_in_place_equals_functional():
    rng = np.random.default_rng(5)
    params = {"a": torch.tensor(rng.normal(0, 1, (4, 3)).astype(np.float32)),
              "b": torch.tensor(rng.normal(0, 1, 5).astype(np.float32))}
    grads = {k: torch.tensor(rng.normal(0, 1, t.shape).astype(np.float32))
             for k, t in params.items()}
    cfg = TA.AdamWConfig(lr=1e-2, warmup_steps=2)
    want_p, want_s, want_m = TA.apply(cfg, grads, TA.init(params), params)
    state = TA.init(params)
    got_s, got_m = TA.apply_(cfg, grads, state, params)
    for k in params:
        assert torch.equal(params[k], want_p[k])
        assert torch.equal(got_s.m[k], want_s.m[k]) and got_s.m[k] is \
            state.m[k]
        assert torch.equal(got_s.v[k], want_s.v[k])
    assert int(got_s.step) == 1 and float(got_m["lr"]) == float(
        want_m["lr"])


def test_lm_tree_is_the_reference_layout_and_loads_back():
    for name in ("granite-3-2b", "zamba2-2.7b", "whisper-tiny"):
        _, tcfg, params, model = _setup(name)
        tree = lm_tree(dict(model.named_parameters()))
        want = jax.tree.map(np.asarray, params)
        _assert_trees_close(tree, want, 0.0)
        fresh = TT.init_model(tcfg, torch.Generator().manual_seed(9))
        load_lm_tree(dict(fresh.named_parameters()), want)
        have = dict(model.named_parameters())
        for n, a in fresh.named_parameters():
            assert torch.equal(a, have[n]), n


def _job(tmp_path, name, **kw):
    return TrainJobConfig(**{**dict(batch=2, seq_len=16, num_steps=4,
                                    save_every=2, ckpt_dir=str(
                                        tmp_path / name), lr=1e-3), **kw})


def _loss_log(hist):
    return lambda step, m, dt: hist.append((step, float(m["loss"])))


def test_trainer_runs_and_resumes(tmp_path):
    """Four steps uninterrupted, against two steps, a crash in the third,
    and a fresh Trainer that resumes from the checkpoint of step 2."""
    _, tcfg = _cfgs("granite-3-2b")
    full = []
    state = Trainer(tcfg, _job(tmp_path, "a"), device="cpu").run(
        _loss_log(full))
    assert [s for s, _ in full] == [0, 1, 2, 3]
    assert all(np.isfinite(x) for _, x in full) and full[-1][1] < full[0][1]

    class Crash(Exception):
        pass

    hist = []

    def crash_at_2(step, m, dt):
        hist.append((step, float(m["loss"])))
        if step == 2:
            raise Crash

    tr = Trainer(tcfg, _job(tmp_path, "b"), device="cpu")
    with pytest.raises(Crash):
        tr.run(crash_at_2)
    tr.ckpt.wait()
    assert tr.ckpt.latest_step() == 2
    resumed = []
    state_b = Trainer(tcfg, _job(tmp_path, "b"), device="cpu").run(
        _loss_log(resumed))
    assert [s for s, _ in resumed] == [2, 3]
    assert hist[:2] == full[:2]
    for (s, a), (_, b) in zip(resumed, full[2:]):
        assert abs(a - b) <= 1e-6 * abs(b), s
    assert int(state_b["opt"].step) == int(state["opt"].step) == 4
    have = dict(state["params"].named_parameters())
    for n, a in state_b["params"].named_parameters():
        torch.testing.assert_close(a, have[n], rtol=1e-5, atol=1e-6, msg=n)
    # nothing left to do: the loop saves once more and returns
    again = []
    Trainer(tcfg, _job(tmp_path, "b"), device="cpu").run(_loss_log(again))
    assert again == []


def _reference_trainer(rcfg, job):
    from repro.launch.mesh import make_host_mesh
    from repro.train.trainer import Trainer as RTrainer
    from repro.train.trainer import TrainJobConfig as RJob

    return RTrainer(rcfg, RJob(**dataclasses.asdict(job)),
                    mesh=make_host_mesh())


@pytest.mark.parametrize("first", ["reference", "port"])
def test_checkpoints_cross_between_the_trainers(tmp_path, first):
    """Two steps by one package's Trainer, checkpointed; each package's
    Trainer resumes from a copy of that checkpoint and takes step 2: the
    losses agree, and the state each writes after it holds the same
    leaves (the reference's layout)."""
    rcfg, tcfg = _cfgs("granite-3-2b")
    job = _job(tmp_path, "first", num_steps=2, save_every=50)
    if first == "reference":
        _reference_trainer(rcfg, job).run()
    else:
        Trainer(tcfg, job, device="cpu").run()
    losses = {}
    for who in ("reference", "port"):
        shutil.copytree(tmp_path / "first", tmp_path / who)
        nxt = _job(tmp_path, who, num_steps=3, save_every=50)
        hist = []
        if who == "reference":
            _reference_trainer(rcfg, nxt).run(_loss_log(hist))
        else:
            Trainer(tcfg, nxt, device="cpu").run(_loss_log(hist))
        assert [s for s, _ in hist] == [2]
        losses[who] = hist[0][1]
    assert abs(losses["port"] - losses["reference"]) <= LOSS_REL * abs(
        losses["reference"])
    from repro.checkpoint.manager import CheckpointManager as RManager

    from repro_torch.checkpoint.manager import CheckpointManager
    rm, tm = RManager(str(tmp_path / "reference")), CheckpointManager(
        str(tmp_path / "port"))
    assert rm.latest_step() == tm.latest_step() == 3
    names = sorted(p.name for p in (tmp_path / "port" / "step_00000003")
                   .iterdir())
    assert names == sorted(p.name for p in (
        tmp_path / "reference" / "step_00000003").iterdir())
    assert "params__blocks__wq.npy" in names and "opt__step.npy" in names
    for n in names:
        if n.endswith(".npy"):
            a = np.load(tmp_path / "port" / "step_00000003" / n)
            b = np.load(tmp_path / "reference" / "step_00000003" / n)
            assert a.shape == b.shape and a.dtype == b.dtype, n


def test_blocking_save_waits_for_queued_writes(tmp_path, monkeypatch):
    """The loop's periodic save of its last step, then its final blocking
    save of the same step: the second write starts after the first has
    published (writes that overlapped swept each other's `.tmp`)."""
    import threading
    import time

    from repro_torch.checkpoint.manager import CheckpointManager

    mgr = CheckpointManager(str(tmp_path))
    spans = []
    write = mgr._write

    def slow(step, host):
        t0 = time.perf_counter()
        time.sleep(0.2)
        write(step, host)
        spans.append((threading.current_thread() is mgr._thread, t0,
                      time.perf_counter()))

    monkeypatch.setattr(mgr, "_write", slow)
    tree = {"w": np.arange(6, dtype=np.float32)}
    mgr.save(4, tree)
    mgr.save(4, tree, blocking=True)
    mgr.wait()
    assert [s[0] for s in spans] == [True, False]
    assert spans[1][1] >= spans[0][2]
    assert mgr.latest_step() == 4


def test_fault_tolerant_loop_and_straggler_policy_match_reference():
    from repro.distributed.elastic import StragglerPolicy as RPolicy

    got, want = StragglerPolicy(max_strikes=2), RPolicy(max_strikes=2)
    for t in (0.5, 0.6, 0.4, 0.55):
        got.record_step(t)
        want.record_step(t)
    assert got.deadline_s == want.deadline_s
    for worker, t in ((1, 9.0), (2, 0.1), (1, 9.0), (3, 2.0), (2, 5.0)):
        assert got.check_worker(worker, t) == want.check_worker(worker, t)
    assert got.evicted == want.evicted == {1}

    class Ckpt:
        def __init__(self):
            self.saved = []

        def save(self, step, state, blocking=False):
            self.saved.append((step, state, blocking))

        def wait(self):
            pass

        def restore_latest(self, target):
            return (self.saved[-1][0], self.saved[-1][1]) if self.saved \
                else (None, None)

    ck = Ckpt()
    loop = FaultTolerantLoop(lambda s, b: (s + b, {"b": b}), ck, save_every=2)
    assert loop.resume_or_init(10) == (10, 0)
    state, step = loop.run(10, lambda i: i, 0, 5)
    assert (state, step) == (20, 5)
    assert [(s, st, b) for s, st, b in ck.saved] == [
        (2, 11, False), (4, 16, False), (5, 20, True)]
    assert loop.resume_or_init(0) == (20, 5)


def test_launch_train_smoke_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    state = train.main(["--arch", "phi-3-vision-4.2b", "--smoke", "--device",
                        "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                        "--ckpt", str(tmp_path / "ck")])
    assert int(state["opt"].step) == 2
    out = capsys.readouterr().out
    assert "arch=phi-3-vision-4.2b-smoke" in out and "step     0 loss" in out
    # --model-parallel 2: two gloo ranks spawned by the launcher, a data 1
    # x model 2 mesh, rank 0 printing and writing the checkpoint
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-3-2b", "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--model-parallel", "2", "--ckpt",
         str(tmp_path / "mp")], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(root / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh={'data': 1, 'model': 2}" in proc.stdout
    assert proc.stdout.count("step     0 loss") == 1
    assert (tmp_path / "mp" / "step_00000002").is_dir()


def test_example_trains_the_tiny_lm_on_cpu(tmp_path, capsys):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_lm_train.py"
    spec = importlib.util.spec_from_file_location("torch_lm_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hist = mod.main(["--steps", "12", "--device", "cpu", "--ckpt",
                     str(tmp_path / "ck")])
    assert len(hist) == 12 and hist[-1] < hist[0]
    assert "training lm-tiny" in capsys.readouterr().out
