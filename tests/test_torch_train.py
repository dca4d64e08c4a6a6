"""The port's SNN training stack (`repro_torch.models.snn` /
`snn_conv`, `core.neuron.spike_fn`, `core.quant.fake_quant`,
`optim.adamw`, `checkpoint.manager`, `data.synthetic`,
`train.snn_trainer`) against the JAX package's, on the CPU.

Parameters, AdamW state and batches are the reference's, carried across
as numpy through `repro_torch.convert_params` / `convert_adamw`; the
fixtures are asserted tie-free (no touched neuron within `MARGIN` of the
threshold along the port's run), so spikes are equal and only rounding
separates the two:

* `spike_fn`'s surrogate and `fake_quant`'s straight-through gradient
  against `jax.grad`;
* `forward` counts and stats, `hw_loss_fn` and its gradients, QAT on and
  off, within `LOSS_RTOL` / `GRAD_RTOL` + `GRAD_ATOL`;
* `adamw.schedule`, `apply` and `global_norm` over 5 steps within
  `ADAM_ULP` ulp;
* `SNNTrainer.step` x 3 against the reference's;
* `EventStream` and `cifar_like_rate_coded` bit-equal;
* checkpoints written by either package restore in the other, and fit
  auto-resumes from either's;
* the conv SNN's forward, gradients and SGD step, and
  `compile_network(ConvSNNConfig)` equal to the reference's.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import compiler as REF_COMP  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as RefCkpt  # noqa: E402
from repro.core import neuron as REF_N  # noqa: E402
from repro.core import quant as REF_Q  # noqa: E402
from repro.data import synthetic as REF_D  # noqa: E402
from repro.models import snn as REF_SNN  # noqa: E402
from repro.models import snn_conv as REF_CONV  # noqa: E402
from repro.optim import adamw as REF_ADAM  # noqa: E402
from repro.train import snn_trainer as REF_TR  # noqa: E402

from repro_torch import compiler as COMP  # noqa: E402
from repro_torch import convert_adamw, convert_params  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core import neuron as N  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.data import synthetic as D  # noqa: E402
from repro_torch.models import snn as SNN  # noqa: E402
from repro_torch.models import snn_conv as CONV  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import snn_trainer as TR  # noqa: E402

MARGIN = 1e-5          # tie-free fixtures: |v_int - theta| > MARGIN
LOSS_RTOL = 1e-5       # losses and stats: f32 sums in another order
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6   # BPTT gradients through T steps
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-7  # after AdamW steps
ADAM_ULP = 4           # AdamW on the same f32 grads
QAT_ULP = 4            # QAT levels: equal words, scales a few ulp apart

EV_KW = dict(timesteps=6, height=8, width=8, seed=3)
EV, REF_EV = D.EventStream(**EV_KW), REF_D.EventStream(**EV_KW)
SIZES = (EV.n_inputs, 48, 10)
HW = dict(rate_weight=1.0, target_rate=0.08, l1_weight=1e-3)


def _cfgs(qat=False):
    port = SNN.SNNConfig(layer_sizes=SIZES, timesteps=6, qat=qat,
                         quant=Q.CodebookConfig(16, 8))
    ref = REF_SNN.SNNConfig(layer_sizes=SIZES, timesteps=6, qat=qat,
                            quant=REF_Q.CodebookConfig(16, 8))
    return port, ref


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_params(seed=6):
    return REF_SNN.init_params(_cfgs()[1], jax.random.PRNGKey(seed))


def _assert_qat_agrees(params, rparams):
    """The fixture's QAT fits agree: Lloyd's k-means sums clusters in
    another order in each framework, and over 25 iterations a point near a
    cluster boundary can flip and move a level (PRNGKey(5) at these
    widths moves one of the 16).  Where they agree, every weight takes
    the same W-bit word, and its level (word x scale, the scale from
    centroids a few ulp apart) is within QAT_ULP."""
    for w, rw in zip(params, rparams):
        got = Q.fake_quant(w.detach(), 16, 8).numpy()
        want = np.asarray(REF_Q.fake_quant(rw, 16, 8))
        assert _ulp_diff(got, want) <= QAT_ULP, "QAT fits diverged"


def _batch(step, batch=16):
    s, l = REF_EV.batch(batch, step)
    return (s, l), (torch.tensor(np.asarray(s)),
                    torch.tensor(np.asarray(l), dtype=torch.int64))


def _run_facts(params, cfg, spikes) -> tuple[float, int]:
    """(smallest |v_int - theta| over touched neurons, exact
    cancellations) of the port's forward, its own arithmetic with QAT
    weights.  A cancellation is a neuron a spike reaches through a
    nonzero synapse whose current sums to exactly 0.0: `lif_step` counts
    it untouched (`current != 0`), and in the other framework's summation
    order it may not be — the one difference in `touched` rounding
    leaves (ROADMAP.md Queue 3, known differences)."""
    with torch.no_grad():
        ws = [SNN._layer_weights(w, cfg) for w in params]
        b, t, _ = spikes.shape
        states = [N.init_batch_state(b, int(w.shape[1]), "cpu") for w in ws]
        margin, cancels = np.inf, 0
        for step in range(t):
            x = spikes[:, step]
            for li, w in enumerate(ws):
                cur = x @ w
                st = states[li]
                v_int = st.v * cfg.lif.leak ** (st.elapsed + 1).float() + cur
                gap = (v_int - cfg.lif.threshold).abs()[cur != 0]
                if gap.numel():
                    margin = min(margin, float(gap.min()))
                reached = N.touch_mask(x, (w != 0).float())
                cancels += int((reached & (cur == 0)).sum())
                states[li], x, _ = N.lif_step(st, cur, cfg.lif)
    return margin, cancels


def _tie_free_batch(params, cfg, rparams, rcfg, batch=16):
    """(reference batch, port batch) of the first batch whose port run
    is tie-free and on which neither framework has an exact cancellation:
    QAT weights lie on a W-bit grid, where about one current in a
    thousand sums to exactly 0.0 in one summation order and not in
    another, which moves `touched` and the surrogate gradient through
    that neuron.  The port's run has none when `_run_facts` counts none;
    the reference's then touches as many neurons (touched is a subset of
    the neurons reached, which the two share).  About one batch in ten
    qualifies, and runs of 60 without one occur (after step 2 of
    `test_trainer_three_steps_match_reference` the first is batch 66).
    Returns the batches and the step of the data stream they came from."""
    for step in range(120):
        ref_b, port_b = _batch(step, batch)
        margin, cancels = _run_facts(params, cfg, port_b[0])
        if margin <= MARGIN or cancels:
            continue
        with torch.no_grad():
            touched = SNN.forward(params, cfg, port_b[0])[1]["touched"]
        if float(touched) == float(REF_SNN.forward(rparams, rcfg,
                                                   ref_b[0])[1]["touched"]):
            return ref_b, port_b, step
    raise RuntimeError("no tie-free batch found")


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()) if isinstance(
        got, torch.Tensor) else np.asarray(got), np.asarray(want),
        rtol=rtol, atol=atol, err_msg=msg)


def _ulp_diff(got, want) -> float:
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.max(np.abs(g - w) / np.spacing(np.maximum(np.abs(w),
                                                               1e-30))))


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("kw", [EV_KW, dict(n_classes=4, height=10, width=7,
                                            timesteps=5, seed=9,
                                            angle_offset=0.7)])
def test_event_stream_bit_equal(kw):
    port, ref = D.EventStream(**kw), REF_D.EventStream(**kw)
    assert port.n_inputs == ref.n_inputs
    for step in (0, 3):
        s, l = port.batch(6, step, device="cpu")
        rs, rl = ref.batch(6, step)
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(l.numpy(), np.asarray(rl))
        assert s.dtype == torch.float32 and l.dtype == torch.int64
    assert port.measured_sparsity(8) == ref.measured_sparsity(8)


def test_cifar_like_rate_coded_bit_equal():
    s, l = D.cifar_like_rate_coded(5, timesteps=3, seed=4, device="cpu")
    rs, rl = REF_D.cifar_like_rate_coded(5, timesteps=3, seed=4)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(l.numpy(), np.asarray(rl))


def test_new_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    cfg = _cfgs()[0]
    for call in (lambda: EV.batch(2), lambda: D.cifar_like_rate_coded(2),
                 lambda: SNN.init_params(cfg),
                 lambda: CONV.init_params(CONV.ConvSNNConfig()),
                 lambda: TR.SNNTrainer(cfg),
                 lambda: convert_params([np.zeros(2)]),
                 lambda: N.init_batch_state(2, 3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# the surrogate gradient and the straight-through estimator


@pytest.mark.parametrize("beta", [4.0, 1.5])
def test_spike_fn_surrogate_matches_jax_grad(beta):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 64).astype(np.float32)
    x[:3] = (0.0, -0.0, -np.inf)
    g = rng.normal(0, 1, 64).astype(np.float32)
    want_y = np.asarray(REF_N.spike_fn(jnp.asarray(x), beta))
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        REF_N.spike_fn(v, beta) * g))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = N.spike_fn(xt, beta)
    (y * torch.tensor(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    assert _ulp_diff(xt.grad.numpy(), want) <= 2
    # no grad asked: the bare comparison, no autograd node
    assert N.spike_fn(torch.tensor(x), beta).grad_fn is None


def test_fake_quant_forward_and_ste_gradient():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.3, (40, 24)).astype(np.float32)
    want = np.asarray(REF_Q.fake_quant(jnp.asarray(w), 16, 8))
    wt = torch.tensor(w, requires_grad=True)
    got = Q.fake_quant(wt, 16, 8)
    # k-means sums clusters in another order: the same word for every
    # weight, levels within QAT_ULP
    assert _ulp_diff(got.detach().numpy(), want) <= QAT_ULP
    g = rng.normal(0, 1, w.shape).astype(np.float32)
    (got * torch.tensor(g)).sum().backward()
    ref_g = np.asarray(jax.grad(lambda v: jnp.sum(
        REF_Q.fake_quant(v, 16, 8) * g))(jnp.asarray(w)))
    np.testing.assert_array_equal(wt.grad.numpy(), ref_g)
    np.testing.assert_array_equal(wt.grad.numpy(), g)
    assert Q._FQ_CACHE[(16, 8)] == Q.CodebookConfig(16, 8)


def test_settle_and_batch_state_match_reference():
    rng = np.random.default_rng(2)
    v = rng.normal(0, 1, (3, 7)).astype(np.float32)
    el = rng.integers(0, 6, (3, 7)).astype(np.int32)
    p = N.LIFParams(leak=0.8)
    got = N.settle_state(N.LIFState(torch.tensor(v), torch.tensor(el)), p)
    want = REF_N.settle_state(REF_N.LIFState(jnp.asarray(v),
                                             jnp.asarray(el)),
                              REF_N.LIFParams(leak=0.8))
    assert _ulp_diff(got.v.numpy(), np.asarray(want.v)) <= 1
    assert not got.elapsed.any()
    st = N.init_batch_state(3, 5, "cpu")
    assert st.v.shape == (3, 5) and st.elapsed.dtype == torch.int32
    assert dataclasses.asdict(N.LIFParams()) == \
        dataclasses.asdict(REF_N.LIFParams())


# ---------------------------------------------------------------------------
# forward, loss and gradients


@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat"])
def test_forward_matches_reference(qat):
    cfg, rcfg = _cfgs(qat)
    rp = _ref_params()
    params = convert_params(_np(rp), "cpu")
    if qat:
        _assert_qat_agrees(params, rp)
    (rs, rl), (s, l), _ = _tie_free_batch(params, cfg, rp, rcfg)
    counts, stats = SNN.forward(params, cfg, s)
    rcounts, rstats = REF_SNN.forward(rp, rcfg, rs)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    assert float(counts.sum()) > 0
    for k in rstats:
        _close(stats[k], rstats[k], LOSS_RTOL, 0.0, k)
    acc = SNN.accuracy(params, cfg, s, l)
    assert float(acc) == float(REF_SNN.accuracy(rp, rcfg, rs, rl))


@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat"])
@pytest.mark.parametrize("reg", [False, True], ids=["ce", "hw"])
def test_hw_loss_and_gradients_match_reference(qat, reg):
    cfg, rcfg = _cfgs(qat)
    hw, rhw = ((TR.HWLossConfig(**HW), REF_TR.HWLossConfig(**HW)) if reg
               else (TR.HWLossConfig(), REF_TR.HWLossConfig()))
    rp = _ref_params()
    params = [p.requires_grad_(True)
              for p in convert_params(_np(rp), "cpu")]
    if qat:
        _assert_qat_agrees(params, rp)
    (rs, rl), (s, l), _ = _tie_free_batch(params, cfg, rp, rcfg)
    loss, (ce, stats) = TR.hw_loss_fn(params, cfg, hw, s, l)
    grads = torch.autograd.grad(loss, params)
    (rloss, (rce, _)), rgrads = jax.value_and_grad(
        REF_TR.hw_loss_fn, has_aux=True)(rp, rcfg, rhw, rs, rl)
    _close(loss, rloss, LOSS_RTOL, 0.0, "loss")
    _close(ce, rce, LOSS_RTOL, 0.0, "ce")
    assert (float(loss.detach()) > float(ce.detach())) == reg
    for li, (g, rg) in enumerate(zip(grads, rgrads)):
        assert float(g.abs().max()) > 0
        _close(g, rg, GRAD_RTOL, GRAD_ATOL, f"grad {li}")
    # the unregularized loss is models.snn's own loss_fn
    if not reg:
        _close(SNN.loss_fn(params, cfg, s, l)[0], rloss, LOSS_RTOL, 0.0)


def test_rate_hinge_excludes_output_layer():
    cfg = _cfgs()[0]
    params = convert_params(_np(_ref_params(0)), "cpu")
    s, l = EV.batch(8, 0, device="cpu")
    hw = TR.HWLossConfig(rate_weight=7.0, target_rate=0.0)
    loss, (ce, stats) = TR.hw_loss_fn(params, cfg, hw, s, l)
    hidden = 7.0 * float(torch.sum(torch.clamp(stats["rates"][:-1],
                                               min=0.0) ** 2))
    np.testing.assert_allclose(float(loss) - float(ce), hidden, rtol=1e-5)


def test_qat_forward_equals_dequantized_forward():
    cfg, _ = _cfgs(qat=True)
    params = SNN.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    s, _ = EV.batch(16, 0, device="cpu")
    c_qat, st_qat = SNN.forward(params, cfg, s)
    deq = [Q.dequantize(Q.quantize(w, cfg.quant)) for w in params]
    c_deq, st_deq = SNN.forward(deq, dataclasses.replace(cfg, qat=False), s)
    assert torch.equal(c_qat, c_deq)
    assert float(st_qat["density"]) == float(st_deq["density"])


def test_init_params_seeded_and_scaled():
    cfg = _cfgs()[0]
    a = SNN.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = SNN.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [tuple(w.shape) for w in a] == [(SIZES[0], 48), (48, 10)]
    std = float(a[0].std())
    assert abs(std - (2.0 / SIZES[0]) ** 0.5) < 0.1 * std


# ---------------------------------------------------------------------------
# AdamW


def _grad_trees(rng, shapes, n):
    return [[rng.normal(0, s, shape).astype(np.float32)
             for shape in shapes] for s in np.linspace(0.05, 3.0, n)]


@pytest.mark.parametrize("kw", [dict(), dict(clip_norm=0.5, warmup_steps=2,
                                             total_steps=5,
                                             weight_decay=0.01)])
def test_adamw_five_steps_within_ulps(kw):
    rng = np.random.default_rng(7)
    shapes = [(17, 5), (5,), (3, 4, 2)]
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    cfg, rcfg = adamw.AdamWConfig(**kw), REF_ADAM.AdamWConfig(**kw)
    params, rparams = convert_params(p0, "cpu"), [jnp.asarray(p) for p in p0]
    state, rstate = adamw.init(params), REF_ADAM.init(rparams)
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    for grads in _grad_trees(rng, shapes, 5):
        assert _ulp_diff(adamw.global_norm(convert_params(grads, "cpu")),
                         REF_ADAM.global_norm(grads)) <= ADAM_ULP
        params, state, m = adamw.apply(cfg, convert_params(grads, "cpu"),
                                       state, params)
        rparams, rstate, rm = REF_ADAM.apply(
            rcfg, [jnp.asarray(g) for g in grads], rstate, rparams)
        assert int(state.step) == int(rstate.step)
        for k in ("grad_norm", "lr"):
            assert _ulp_diff(m[k], rm[k]) <= ADAM_ULP, k
        assert _ulp_diff(adamw.schedule(cfg, state.step),
                         REF_ADAM.schedule(rcfg, rstate.step)) <= ADAM_ULP
        for tree, rtree in ((params, rparams), (state.m, rstate.m),
                            (state.v, rstate.v)):
            for a, b in zip(tree, rtree):
                assert _ulp_diff(a, b) <= ADAM_ULP


def test_adamw_over_a_dict_and_bf16_leaves():
    rng = np.random.default_rng(8)
    p0 = {"head": rng.normal(0, 1, (6, 3)).astype(np.float32),
          "conv0": rng.normal(0, 1, (3, 3, 2, 4)).astype(np.float32)}
    g = {k: rng.normal(0, 1, v.shape).astype(np.float32)
         for k, v in p0.items()}
    cfg = adamw.AdamWConfig(warmup_steps=1)
    params = convert_params(p0, "cpu")
    new, state, m = adamw.apply(cfg, convert_params(g, "cpu"),
                                adamw.init(params), params)
    rnew, rstate, rm = REF_ADAM.apply(REF_ADAM.AdamWConfig(warmup_steps=1),
                                      jax.tree.map(jnp.asarray, g),
                                      REF_ADAM.init(jax.tree.map(
                                          jnp.asarray, p0)),
                                      jax.tree.map(jnp.asarray, p0))
    assert set(new) == set(rnew)
    for k in new:
        assert _ulp_diff(new[k], rnew[k]) <= ADAM_ULP
    bf = {"w": params["head"].to(torch.bfloat16)}
    out, st, _ = adamw.apply(cfg, {"w": torch.ones(6, 3)}, adamw.init(bf), bf)
    assert out["w"].dtype == torch.bfloat16
    assert st.m["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the trainer


def _trainers(steps=3, **kw):
    cfg, rcfg = _cfgs(qat=True)
    tk = dict(steps=steps, lr=5e-3, **kw)
    return (TR.SNNTrainer(cfg, TR.SNNTrainConfig(
        hw=TR.HWLossConfig(**HW), **tk), device="cpu"),
        REF_TR.SNNTrainer(rcfg, REF_TR.SNNTrainConfig(
            hw=REF_TR.HWLossConfig(**HW), **tk)))


def test_trainer_three_steps_match_reference():
    tr, rtr = _trainers()
    rparams, rstate = rtr.init(jax.random.PRNGKey(6))
    params = convert_params(_np(rparams), "cpu")
    state = convert_adamw(rstate.step, _np(rstate.m), _np(rstate.v), "cpu")
    found = []
    for step in range(3):
        _assert_qat_agrees(params, rparams)
        (rs, rl), (s, l), at = _tie_free_batch(params, tr.cfg, rparams,
                                               rtr.cfg)
        found.append(at)
        params, state, m = tr.step(params, state, s, l)
        rparams, rstate, rm = rtr.step(rparams, rstate, rs, rl)
        assert int(state.step) == int(rstate.step) == step + 1
        for k in rm:
            _close(m[k], rm[k], GRAD_RTOL, 0.0, f"step {step}: {k}")
        for a, b in zip(params, rparams):
            _close(a, b, PARAM_RTOL, PARAM_ATOL, f"step {step}")
        for a, b in zip(state.m, rstate.m):
            _close(a, b, GRAD_RTOL, GRAD_ATOL, f"step {step}: m")
    # where each step found its batch: a change to the fits or the forward
    # that moves a step's batch shows here, not as a longer search
    assert found == [1, 1, 66]


def test_trainer_loss_decreases():
    cfg = dataclasses.replace(_cfgs()[0], layer_sizes=(EV.n_inputs, 64, 10))
    tr = TR.SNNTrainer(cfg, TR.SNNTrainConfig(steps=12, lr=5e-3),
                       device="cpu")
    params, hist = tr.fit(lambda s: EV.batch(32, s, device="cpu"))
    assert len(hist) == 12 and np.isfinite([h["loss"] for h in hist]).all()
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert last < first, (first, last)
    ev = tr.evaluate(params, *EV.batch(32, 999, device="cpu"))
    assert set(ev) == {"accuracy", "density", "sparsity", "touch_fraction",
                       "mean_rate"}


def test_fit_resumes_after_an_interruption(tmp_path):
    """Stopped after step 2, a second fit resumes from the checkpoint
    and ends where an uninterrupted fit ends."""
    def batches(stop=None):
        def fn(step):
            if step == stop:
                raise KeyboardInterrupt
            return EV.batch(8, step, device="cpu")
        return fn

    def trainer(d):
        return TR.SNNTrainer(_cfgs()[0], TR.SNNTrainConfig(
            steps=5, lr=5e-3, ckpt_dir=str(d), save_every=2), device="cpu")

    whole, _ = trainer(tmp_path / "a").fit(batches())
    with pytest.raises(KeyboardInterrupt):
        trainer(tmp_path / "b").fit(batches(stop=2))
    assert trainer(tmp_path / "b").ckpt.latest_step() == 2
    resumed, hist = trainer(tmp_path / "b").fit(batches())
    assert [h["step"] for h in hist] == [2, 3, 4]
    for a, b in zip(resumed, whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_fit_auto_resumes_from_either_package(tmp_path, writer):
    tr, rtr = _trainers(steps=4, ckpt_dir=str(tmp_path / "ck"),
                        save_every=2)
    first = rtr if writer == "reference" else tr
    second = tr if writer == "reference" else rtr
    if writer == "reference":
        p1, h1 = first.fit(lambda s: REF_EV.batch(8, s))
        p2, h2 = second.fit(lambda s: EV.batch(8, s, device="cpu"))
    else:
        p1, h1 = first.fit(lambda s: EV.batch(8, s, device="cpu"))
        p2, h2 = second.fit(lambda s: REF_EV.batch(8, s))
    assert len(h1) == 4 and h2 == []
    for a, b in zip(p1, p2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# checkpoints


def _trees():
    rng = np.random.default_rng(9)
    w = rng.normal(0, 1, (3, 4)).astype(np.float32)
    b = rng.normal(0, 1, (4,)).astype(np.float32)
    ref = {"params": [jnp.asarray(w), jnp.asarray(b, jnp.bfloat16)],
           "opt": REF_ADAM.AdamWState(step=jnp.asarray(3, jnp.int32),
                                      m=[jnp.zeros((3, 4)), jnp.ones((4,))],
                                      v=[jnp.ones((3, 4)), jnp.zeros((4,))])}
    port = {"params": [torch.tensor(w),
                       torch.tensor(b).to(torch.bfloat16)],
            "opt": adamw.AdamWState(
                step=torch.tensor(3, dtype=torch.int32),
                m=[torch.zeros(3, 4), torch.ones(4)],
                v=[torch.ones(3, 4), torch.zeros(4)])}
    return ref, port


def _assert_trees_equal(port_tree, ref_tree):
    got = jax.tree.leaves(jax.tree.map(
        lambda x: x, {"params": port_tree["params"],
                      "opt": list(port_tree["opt"])}))
    want = jax.tree.leaves({"params": ref_tree["params"],
                            "opt": list(ref_tree["opt"])})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        wn = np.asarray(w, np.float32) if w.dtype == jnp.bfloat16 \
            else np.asarray(w)
        gn = g.to(torch.float32).numpy() if g.dtype == torch.bfloat16 \
            else g.numpy()
        np.testing.assert_array_equal(gn, wn)
        assert (g.dtype == torch.bfloat16) == (w.dtype == jnp.bfloat16)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    ref_tree, port_tree = _trees()
    d = str(tmp_path / "ck")
    if writer == "port":
        CheckpointManager(d, async_writes=False).save(7, port_tree)
        got = RefCkpt(d, async_writes=False).restore(7, ref_tree)
        _assert_trees_equal(port_tree, got)
        back = CheckpointManager(d).restore(7, port_tree)
        _assert_trees_equal(back, ref_tree)
    else:
        RefCkpt(d, async_writes=False).save(7, ref_tree)
        got = CheckpointManager(d, async_writes=False).restore(7, port_tree)
        _assert_trees_equal(got, ref_tree)
        assert isinstance(got["opt"], adamw.AdamWState)
        assert got["opt"].step.dtype == torch.int32
    with open(os.path.join(d, "step_00000007", "MANIFEST.json")) as f:
        text = f.read()
    assert '"opt/m/0"' in text and '"params/1"' in text
    assert sorted(os.listdir(os.path.join(d, "step_00000007"))) == sorted(
        ["MANIFEST.json", "opt__m__0.npy", "opt__m__1.npy", "opt__step.npy",
         "opt__v__0.npy", "opt__v__1.npy", "params__0.npy",
         "params__1.npy"])


def test_checkpoint_async_gc_stale_tmp_and_mismatch(tmp_path):
    _, tree = _trees()
    d = str(tmp_path / "ck")
    m = CheckpointManager(d, max_to_keep=2, async_writes=True)
    for step in (1, 2, 3, 4):
        m.save(step, tree)
    m.wait()
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == \
        ["step_00000003", "step_00000004"]
    stale = os.path.join(d, "step_00000099.tmp")
    os.makedirs(stale)
    np.save(os.path.join(stale, "params__0.npy"), np.zeros((3, 4)))
    assert m.latest_step() == 4 and m.restore_latest(tree)[0] == 4
    m.save(5, tree, blocking=True)
    assert not os.path.exists(stale) and m.latest_step() == 5
    with pytest.raises(ValueError, match="structure mismatch"):
        m.restore(5, {"params": tree["params"]})
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        tree) == (None, None)


# ---------------------------------------------------------------------------
# the conv SNN


def _conv_cfgs():
    kw = dict(in_shape=(8, 8, 2), channels=(4, 6), kernel=3, n_classes=5,
              timesteps=4)
    return CONV.ConvSNNConfig(**kw), REF_CONV.ConvSNNConfig(**kw)


def _conv_batch(step):
    rng = np.random.default_rng(50 + step)
    s = (rng.random((4, 4, 8, 8, 2)) < 0.3).astype(np.float32)
    return s, rng.integers(0, 5, 4)


def _conv_margin(params, cfg, spikes) -> float:
    """Smallest |v_int - theta| over touched neurons of the port's conv
    forward."""
    gaps = []
    orig = CONV.lif_step

    def spy(st, cur, p, touched=None):
        v_int = st.v * p.leak ** (st.elapsed + 1).float() + cur
        gap = (v_int - p.threshold).abs()[cur != 0]
        if gap.numel():
            gaps.append(float(gap.min()))
        return orig(st, cur, p, touched)

    CONV.lif_step = spy
    try:
        with torch.no_grad():
            CONV.forward(params, cfg, spikes)
    finally:
        CONV.lif_step = orig
    return min(gaps) if gaps else np.inf


def test_conv_snn_forward_gradients_and_sgd_match_reference():
    cfg, rcfg = _conv_cfgs()
    rp = REF_CONV.init_params(rcfg, jax.random.PRNGKey(2))
    params = convert_params(_np(rp), "cpu")
    for step in range(20):
        s, l = _conv_batch(step)
        st = torch.tensor(s)
        if _conv_margin(params, cfg, st) > MARGIN:
            break
    else:
        raise RuntimeError("no tie-free conv batch")
    lt = torch.tensor(l)
    counts, stats = CONV.forward(params, cfg, st)
    rcounts, rstats = REF_CONV.forward(rp, rcfg, jnp.asarray(s))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    for k in rstats:
        _close(stats[k], rstats[k], LOSS_RTOL, 0.0, k)
    ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, _ = CONV.loss_fn(ps, cfg, st, lt)
    grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    (rloss, _), rgrads = jax.value_and_grad(REF_CONV.loss_fn, has_aux=True)(
        rp, rcfg, jnp.asarray(s), jnp.asarray(l, jnp.int32))
    _close(loss, rloss, LOSS_RTOL, 0.0, "loss")
    for k in rgrads:
        _close(grads[k], rgrads[k], GRAD_RTOL, GRAD_ATOL, k)
    new, sloss, _ = CONV.sgd_step(params, cfg, st, lt, lr=0.3)
    rnew, rsloss, _ = REF_CONV.sgd_step(rp, rcfg, jnp.asarray(s),
                                        jnp.asarray(l, jnp.int32), lr=0.3)
    _close(sloss, rsloss, LOSS_RTOL, 0.0)
    for k in rnew:
        _close(new[k], rnew[k], PARAM_RTOL, PARAM_ATOL, k)
    assert float(CONV.accuracy(params, cfg, st, lt)) == float(
        REF_CONV.accuracy(rp, rcfg, jnp.asarray(s), jnp.asarray(l)))


def test_conv_init_shapes():
    cfg, rcfg = _conv_cfgs()
    got = CONV.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    want = REF_CONV.init_params(rcfg, jax.random.PRNGKey(1))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("cfg_kw", [
    dict(), dict(in_shape=(34, 34, 2), channels=(8, 16), n_classes=10)])
def test_compile_network_of_conv_config_equal(cfg_kw):
    got = COMP.compile_network(CONV.ConvSNNConfig(**cfg_kw), anneal_iters=200)
    want = REF_COMP.compile_network(REF_CONV.ConvSNNConfig(**cfg_kw),
                                    anneal_iters=200)
    assert got.summary() == want.summary()
    rows = [[(a.core_id, a.layer, a.neuron_lo, a.neuron_hi)
             for a in c.to_soc_mapping().assignments] for c in (got, want)]
    assert rows[0] == rows[1]
