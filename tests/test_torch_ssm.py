"""The port's ssm and hybrid families against the JAX package, on the CPU.

Fixtures at f32: the reference's own `tiny("ssm")` and `tiny("hybrid")`
(tests/test_models.py) and the SMOKE configs of mamba2-130m and
zamba2-2.7b, each with the reference's `init_model(PRNGKey(0))` carried
across by `convert_lm`.  Every function of `models/mamba2.py`, the
SSD scan at a chunk multiple and the forward at S = 24 and S = 13 (the
end padding), prefill with every cache, four decode steps, the batched
`Server`, C3 serving of the reference's quantized blocks (the
quantization threshold lowered in both packages, so that `in_proj`,
`out_proj` and `conv_w` quantize at these sizes), and `launch.serve`.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.convert import convert_lm
from repro_torch.kernels import ops
from repro_torch.models import common as TC
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT
from repro_torch.quant import lm_quant as TQ
from repro_torch.serve import server as TS

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as RR  # noqa: E402
from repro.models import common as RC  # noqa: E402
from repro.models import mamba2 as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.quant import lm_quant as RQ  # noqa: E402

STEP_TOL = 1e-5      # one function of a layer: a few ulp
LOGIT_TOL = 1e-4     # a scan, whole models, C3 (as tests/test_torch_lm.py)
SERVE_GAP = 1e-3     # fixture check: no top-2 logit gap below this
QUANT_MIN = 1 << 10  # C3 threshold here: in_proj, out_proj, conv_w quantize

_TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab=97)
FIXTURES = {
    "ssm": dict(n_heads=0, n_kv_heads=0, d_ff=0, ssm_state=16,
                ssm_head_dim=32, ssm_chunk=8),
    "hybrid": dict(n_layers=4, n_kv_heads=4, ssm_state=16, ssm_head_dim=32,
                   ssm_chunk=8, attn_every=2),
    "mamba2-130m": None,
    "zamba2-2.7b": None,
}


def _cfgs(fixture):
    """The fixture as the reference's and the port's f32 ArchConfig."""
    kw = FIXTURES[fixture]
    if kw is None:
        return (dataclasses.replace(RR.get_arch(fixture, smoke=True),
                                    dtype=jnp.float32),
                dataclasses.replace(TR.get_arch(fixture, smoke=True),
                                    dtype=torch.float32))
    base = dict(_TINY, **kw)
    return (RC.ArchConfig(f"{fixture}-t", fixture, dtype=jnp.float32, **base),
            TC.ArchConfig(f"{fixture}-t", fixture, dtype=torch.float32,
                          **base))


@functools.cache
def _setup(fixture):
    rcfg, tcfg = _cfgs(fixture)
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(0))
    return rcfg, tcfg, params, convert_lm(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _layer(fixture, i=0):
    """Layer i's leaves: the reference's dict and the port's."""
    _, _, params, model = _setup(fixture)
    return (jax.tree.map(lambda a: a[i], params["blocks"]),
            {k: v.detach() for k, v in model.blocks[i].leaves().items()})


def _x(seed, *shape, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# configs, init, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_dims_and_init_cache_match_reference(fixture):
    rcfg, tcfg = _cfgs(fixture)
    assert TM.dims(tcfg) == RM.dims(rcfg)
    assert TM.conv_channels(tcfg) == RM.conv_channels(rcfg)
    bf = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    got = TM.init_cache(bf, 3, bf.dtype, device="cpu")
    want = RM.init_cache(dataclasses.replace(rcfg, dtype=jnp.bfloat16), 3,
                         jnp.bfloat16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not bool(g.any())
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("fixture", ["ssm", "hybrid"])
def test_init_decode_state_matches_reference(fixture):
    rcfg, tcfg = _cfgs(fixture)
    rcfg = dataclasses.replace(rcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    want = RT.init_decode_state(rcfg, 3, 20)
    got = TT.init_decode_state(tcfg, 3, 20, device="cpu")
    pairs = list(zip(got.ssm, want.ssm))
    if fixture == "hybrid":
        pairs += list(zip(got.shared_kv, want.shared_kv))
    else:
        assert got.shared_kv == () and want.shared_kv == ()
    assert got.kv == () and want.kv == () and got.enc_out == ()
    for g, w in pairs:
        assert tuple(g.shape) == w.shape and not bool(g.any())
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert int(got.pos) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_init_mamba2_names_shapes_types_and_scales(dtype):
    rcfg, tcfg = _cfgs("mamba2-130m")
    rcfg = dataclasses.replace(rcfg, dtype=jnp.bfloat16 if dtype ==
                               torch.bfloat16 else jnp.float32)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(1))
    model = TT.init_model(tcfg, torch.Generator().manual_seed(1))
    blk = model.blocks[0]
    assert set(blk.leaves()) == set(params["blocks"])
    for name, w in params["blocks"].items():
        assert tuple(blk[name].shape) == w.shape[1:], name
        assert str(blk[name].dtype).split(".")[-1] == str(w.dtype), name
    assert blk["A_log"].dtype == blk["D"].dtype == torch.float32
    assert torch.equal(blk["A_log"], torch.ones(TM.dims(tcfg)[1]))
    assert not bool(blk["D"].any() | blk["dt_bias"].any()
                    | blk["conv_b"].any())
    big = dataclasses.replace(tcfg, d_model=256, n_layers=3)
    b0 = TT.init_model(big, torch.Generator().manual_seed(2)).blocks[0]
    d_in = 2 * 256
    for t, std in ((b0["in_proj"], 256 ** -0.5),
                   (b0["out_proj"], d_in ** -0.5 / 6 ** 0.5),
                   (b0["conv_w"], big.ssm_conv ** -0.5)):
        assert abs(float(t.detach().float().std()) / std - 1) < 0.05


def test_convert_lm_carries_hybrid_bf16_bit_for_bit():
    """zamba2's SMOKE weights as bf16 arrays (the f32 fixture rounded),
    the f32 A_log / D / dt_bias kept: every tensor, the shared block's
    too, bit for bit."""
    tcfg = TR.get_arch("zamba2-2.7b", smoke=True)          # bf16
    npp = jax.tree.map(
        lambda a: np.asarray(a) if a.dtype == jnp.float32 and a.ndim == 2
        and a.shape[1] == TM.dims(tcfg)[1] else np.asarray(
            a.astype(jnp.bfloat16)), _setup("zamba2-2.7b")[2])
    model = convert_lm(npp, tcfg, device="cpu")
    names = dict(model.named_parameters())
    assert {n for n in names if n.startswith("shared_attn.")} == {
        f"shared_attn.{k}" for k in npp["shared_attn"]}
    assert names["blocks.0.A_log"].dtype == torch.float32
    for name, t in names.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            r = npp["blocks"][parts[2]][int(parts[1])]
        elif parts[0] == "shared_attn":
            r = npp["shared_attn"][parts[1]]
        else:
            r = npp[name]
        bits = (torch.int16, np.int16) if r.dtype.name == "bfloat16" else (
            torch.int32, np.int32)
        assert t.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[r.dtype.name], name
        assert np.array_equal(t.detach().view(bits[0]).numpy(),
                              np.ascontiguousarray(r).view(bits[1])), name


def test_transformer_checks_the_family_extras():
    _, tcfg, params, model = _setup("hybrid")
    npp = jax.tree.map(np.asarray, params)
    del npp["shared_attn"]
    with pytest.raises(ValueError, match="shared_attn"):
        convert_lm(npp, tcfg, device="cpu")
    blocks = [b.leaves() for b in model.blocks]
    with pytest.raises(ValueError, match="shared_attn"):
        TT.Transformer(_setup("ssm")[1], model.embed, model.unembed,
                       model.final_norm, blocks[:2], **model.extras())
    bad = dict(model.extras()["shared_attn"])
    bad["wq"] = bad["wq"][:, :8]
    with pytest.raises(ValueError, match="shared_attn.wq"):
        TT.Transformer(tcfg, model.embed, model.unembed, model.final_norm,
                       blocks, shared_attn=bad)
    with pytest.raises(ValueError, match="attn_every"):
        TT.init_model(dataclasses.replace(tcfg, n_layers=3),
                      torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# models/mamba2.py, function by function
# ---------------------------------------------------------------------------

def test_split_proj_and_causal_conv_match_reference():
    rcfg, tcfg = _cfgs("ssm")
    lp, blk = _layer("ssm")
    ch = TM.conv_channels(tcfg)
    proj = _x(0, 2, 9, lp["in_proj"].shape[1])
    for g, w in zip(TM._split_proj(torch.tensor(proj), tcfg),
                    RM._split_proj(jnp.asarray(proj), rcfg)):
        assert torch.equal(g, torch.tensor(np.asarray(w)))
    xbc = _x(1, 2, 9, ch)
    b = _x(2, ch, scale=0.1)
    got = TM._causal_conv_train(torch.tensor(xbc), blk["conv_w"],
                                torch.tensor(b))
    want = RM._causal_conv_train(jnp.asarray(xbc), lp["conv_w"],
                                 jnp.asarray(b))
    _close(got, want, STEP_TOL)
    state = _x(3, 2, tcfg.ssm_conv - 1, ch)
    got, g_state = TM._causal_conv_step(torch.tensor(xbc[:, :1]),
                                        torch.tensor(state), blk["conv_w"],
                                        torch.tensor(b))
    want, w_state = RM._causal_conv_step(jnp.asarray(xbc[:, :1]),
                                         jnp.asarray(state), lp["conv_w"],
                                         jnp.asarray(b))
    _close(got, want, STEP_TOL)
    assert torch.equal(g_state, torch.tensor(np.asarray(w_state)))


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init-state"])
def test_ssd_chunked_matches_reference_and_recurrence(init):
    """S a chunk multiple (4 chunks of 8); against the reference's scan
    and the step recurrence its own test holds it to."""
    b, s, h, p, n = 2, 32, 3, 8, 5
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (b, s, h)))).astype(np.float32)
    A = -np.exp(rng.normal(0, 0.3, h)).astype(np.float32)
    B = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    C = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    s0 = rng.normal(0, 1, (b, h, n, p)).astype(np.float32) if init else None
    y, final = TM.ssd_chunked(*map(torch.tensor, (x, dt, A, B, C)), 8,
                              None if s0 is None else torch.tensor(s0))
    wy, wfinal = RM.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), 8,
                                None if s0 is None else jnp.asarray(s0))
    assert y.dtype == final.dtype == torch.float32
    _close(y, wy, LOGIT_TOL)
    _close(final, wfinal, LOGIT_TOL)
    state = np.zeros((b, h, n, p), np.float64) if s0 is None else s0.astype(
        np.float64)
    ys = []
    for t in range(s):
        state = (state * np.exp(dt[:, t] * A)[..., None, None]
                 + np.einsum("bh,bn,bhp->bhnp", dt[:, t], B[:, t], x[:, t]))
        ys.append(np.einsum("bn,bhnp->bhp", C[:, t], state))
    _close(y, np.stack(ys, axis=1), 1e-3)
    _close(final, state, 1e-3)
    with pytest.raises(ValueError, match="multiple of chunk"):
        TM.ssd_chunked(*map(torch.tensor, (x, dt, A, B, C)), 7)


@pytest.mark.parametrize("s", [24, 13], ids=["S24", "S13-padded"])
def test_mamba2_forward_matches_reference(s):
    """S = 13 pads 3 steps at the end (chunk 8): zero dt after softplus,
    so the final state is the 13-step one."""
    rcfg, tcfg = _cfgs("ssm")
    lp, blk = _layer("ssm", 1)
    x = _x(s, 2, s, tcfg.d_model)
    want, wc = RM.mamba2_forward(jnp.asarray(x), lp, rcfg, return_cache=True)
    got, gc = TM.mamba2_forward(torch.tensor(x), blk, tcfg,
                                return_cache=True)
    _close(got, want, LOGIT_TOL)
    _close(gc.conv, wc.conv, LOGIT_TOL)
    _close(gc.state, wc.state, LOGIT_TOL)
    assert gc.state.dtype == torch.float32
    _close(TM.mamba2_forward(torch.tensor(x), blk, tcfg), want, LOGIT_TOL)
    if s == 24:
        _close(TT._ssm_block(torch.tensor(x), blk, tcfg),
               RT._ssm_block(jnp.asarray(x), lp, rcfg), LOGIT_TOL)
    # into a given cache, in place
    into = TM.init_cache(tcfg, 2, torch.float32, device="cpu")
    _, same = TM.mamba2_forward(torch.tensor(x), blk, tcfg, into,
                                return_cache=True)
    assert same.conv is into.conv and torch.equal(into.state, gc.state)


def test_mamba2_decode_matches_reference():
    """Four steps from a random cache, each fed the step before's."""
    rcfg, tcfg = _cfgs("ssm")
    lp, blk = _layer("ssm")
    ch = TM.conv_channels(tcfg)
    d_in, nh, n, hp = TM.dims(tcfg)
    rc = RM.SSMCache(jnp.asarray(_x(1, 2, tcfg.ssm_conv - 1, ch)),
                     jnp.asarray(_x(2, 2, nh, n, hp)))
    tc = TM.SSMCache(*(torch.tensor(np.asarray(a)) for a in rc))
    for step in range(4):
        x = _x(10 + step, 2, 1, tcfg.d_model)
        want, rc = RM.mamba2_decode(jnp.asarray(x), lp, rcfg, rc)
        got, tc = TM.mamba2_decode(torch.tensor(x), blk, tcfg, tc)
        _close(got, want, STEP_TOL)
        _close(tc.conv, rc.conv, STEP_TOL)
        _close(tc.state, rc.state, STEP_TOL)


def test_short_prompt_raises():
    """A prompt shorter than ssm_conv - 1 leaves a conv window the
    reference's decode step cannot use: the port says so at prefill."""
    _, tcfg, _, model = _setup("ssm")
    toks = torch.tensor(_tokens(0, 2, tcfg.ssm_conv - 2, tcfg.vocab))
    with pytest.raises(ValueError, match="ssm_conv - 1"):
        TT.forward_prefill(model, tcfg, {"tokens": toks}, 8)
    lg, st = TT.forward_prefill(model, tcfg, {"tokens": torch.tensor(
        _tokens(0, 2, tcfg.ssm_conv - 1, tcfg.vocab))}, 8)
    assert bool(lg.isfinite().all())
    with pytest.raises(ValueError, match="ssm_conv - 1"):
        TM.mamba2_decode(torch.zeros(2, 1, tcfg.d_model), model.blocks[0],
                         tcfg, TM.init_cache(dataclasses.replace(
                             tcfg, ssm_conv=3), 2, torch.float32, "cpu"))


# ---------------------------------------------------------------------------
# the models: prefill, caches, decode
# ---------------------------------------------------------------------------

def _hold_state(got, want, tol=LOGIT_TOL):
    _close(got.ssm.conv, want.ssm.conv, tol)
    _close(got.ssm.state, want.ssm.state, tol)
    if want.shared_kv != ():
        _close(got.shared_kv.k, want.shared_kv.k, tol)
        _close(got.shared_kv.v, want.shared_kv.v, tol)
    assert got.ssm.state.dtype == torch.float32
    assert int(got.pos) == int(want.pos)


@pytest.mark.parametrize("fixture", list(FIXTURES))
@pytest.mark.parametrize("s", [24, 13], ids=["S24", "S13-padded"])
def test_forward_prefill_matches_reference(fixture, s):
    rcfg, tcfg, params, model = _setup(fixture)
    toks = _tokens(s, 2, s, tcfg.vocab)
    want, rst = RT.forward_prefill(params, rcfg, {"tokens": jnp.asarray(toks)},
                                   s + 8)
    got, st = TT.forward_prefill(model, tcfg, {"tokens": torch.tensor(toks)},
                                 s + 8)
    _close(got, want, LOGIT_TOL)
    _hold_state(st, rst)


@pytest.mark.parametrize("fixture", ["ssm", "hybrid", "zamba2-2.7b"])
def test_four_decode_steps_match_reference(fixture):
    rcfg, tcfg, params, model = _setup(fixture)
    toks = _tokens(11, 2, 17, tcfg.vocab)
    _, rst = RT.forward_prefill(params, rcfg,
                                {"tokens": jnp.asarray(toks[:, :13])}, 24)
    _, st = TT.forward_prefill(model, tcfg,
                               {"tokens": torch.tensor(toks[:, :13])}, 24)
    for i in range(13, 17):
        want, rst = RT.forward_decode(params, rcfg, rst,
                                      jnp.asarray(toks[:, i:i + 1]))
        got, st2 = TT.forward_decode(model, tcfg, st,
                                     torch.tensor(toks[:, i:i + 1]))
        assert st2.ssm.state is st.ssm.state        # updated in place
        st = st2
        _close(got, want, LOGIT_TOL)
        _hold_state(st, rst)


@pytest.mark.parametrize("fixture", ["ssm", "hybrid"])
def test_decode_continues_prefill(fixture):
    """The reference's own property: prefill over S + 1 tokens equals
    prefill over S then one decode step (S = 16: two chunks, then 17
    padded to three)."""
    _, tcfg, _, model = _setup(fixture)
    toks = torch.tensor(_tokens(12, 2, 17, tcfg.vocab))
    full, _ = TT.forward_prefill(model, tcfg, {"tokens": toks}, 24)
    _, st = TT.forward_prefill(model, tcfg, {"tokens": toks[:, :16]}, 24)
    got, st = TT.forward_decode(model, tcfg, st, toks[:, 16:])
    _close(got, full, LOGIT_TOL)
    assert int(st.pos) == 17


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve_both(rcfg, tcfg, rparams, tmodel, prompts, new=4):
    from repro.launch.mesh import make_host_mesh
    from repro.serve.server import Request as RRequest
    from repro.serve.server import Server as RServer

    gaps = []

    def greedy(lg):
        top2 = np.sort(np.asarray(lg), axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        return jnp.argmax(lg, axis=-1)

    rsrv = RServer(rcfg, rparams, make_host_mesh(), batch_slots=2,
                   cache_len=32)
    tsrv = TS.Server(tcfg, tmodel, device="cpu", batch_slots=2, cache_len=32)
    for i, pr in enumerate(prompts):
        rsrv.submit(RRequest(uid=i, prompt=pr, max_new_tokens=new))
        tsrv.submit(TS.Request(uid=i, prompt=pr, max_new_tokens=new))
    want = rsrv.run(sample=greedy)
    assert min(gaps) > SERVE_GAP          # the fixture has no near-tie
    got = tsrv.run()
    assert [r.uid for r in got] == [r.uid for r in want]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == new for r in got)


@pytest.mark.parametrize("fixture", ["ssm", "hybrid"])
def test_server_tokens_equal_reference(fixture):
    rcfg, tcfg, params, model = _setup(fixture)
    prompts = [np.random.default_rng(30 + i).integers(0, tcfg.vocab, 20)
               .astype(np.int32) for i in range(3)]
    _serve_both(rcfg, tcfg, params, model, prompts)


@pytest.fixture
def quant_min(monkeypatch):
    """The C3 threshold lowered in both packages, at runtime only."""
    monkeypatch.setattr(RQ, "_QUANT_MIN_SIZE", QUANT_MIN)
    monkeypatch.setattr(TQ, "_QUANT_MIN_SIZE", QUANT_MIN)


@pytest.mark.parametrize("fixture,pack", [("ssm", False), ("ssm", True),
                                          ("hybrid", False)],
                         ids=["ssm-int8", "ssm-4bit", "hybrid-int8"])
def test_c3_prefill_and_decode_match_reference(fixture, pack, quant_min,
                                               monkeypatch):
    """The reference's quantized blocks carried across and served with
    each package's param_transform: in_proj / out_proj on the codebook
    product (two calls per layer and forward), conv_w read dense."""
    rcfg, tcfg, params, _ = _setup(fixture)
    qb = RQ.quantize_blocks(params["blocks"], pack_4bit=pack)
    assert {n for n, v in qb.items() if isinstance(v, dict)} == {
        "in_proj", "out_proj", "conv_w"}
    qp = dict(params, blocks=qb)
    qmodel = convert_lm(jax.tree.map(np.asarray, qp), tcfg, device="cpu")
    rpt = RQ.make_param_transform(jnp.float32)
    tpt = TQ.make_param_transform(torch.float32)
    calls = []
    plain = ops.codebook_matmul

    def spy(x, idx, cb):
        calls.append(tuple(idx.shape))
        return plain(x, idx, cb)

    monkeypatch.setattr(ops, "codebook_matmul", spy)
    toks = _tokens(5, 2, 15, tcfg.vocab)
    want, rst = RT.forward_prefill(qp, rcfg, {"tokens": jnp.asarray(
        toks[:, :13])}, 24, param_transform=rpt)
    got, st = TT.forward_prefill(qmodel, tcfg, {"tokens": torch.tensor(
        toks[:, :13])}, 24, param_transform=tpt)
    _close(got, want, LOGIT_TOL)
    _hold_state(st, rst)
    assert len(calls) == 2 * tcfg.n_layers
    for i in (13, 14):
        want, rst = RT.forward_decode(qp, rcfg, rst, jnp.asarray(
            toks[:, i:i + 1]), param_transform=rpt)
        got, st = TT.forward_decode(qmodel, tcfg, st, torch.tensor(
            toks[:, i:i + 1]), param_transform=tpt)
        _close(got, want, LOGIT_TOL)
        _hold_state(st, rst)
    assert len(calls) == 3 * 2 * tcfg.n_layers


def test_quantize_blocks_keeps_the_shared_block(quant_min):
    """The port's own fit quantizes the blocks' in_proj, out_proj and
    conv_w, and carries zamba2's shared attention block over as it was;
    the quantized-serving server gives the reference's tokens on the
    reference's quantized blocks."""
    from repro_torch.core.quant import CodebookConfig

    rcfg, tcfg, params, model = _setup("hybrid")
    q = TQ.quantize_blocks(model, CodebookConfig(16, 8, kmeans_iters=2))
    assert {n for n, v in q.blocks[0].leaves().items()
            if isinstance(v, dict)} == {"in_proj", "out_proj", "conv_w"}
    for name, t in model.shared_attn.leaves().items():
        assert torch.equal(q.shared_attn[name], t), name
    qp = dict(params, blocks=RQ.quantize_blocks(params["blocks"]))
    qmodel = convert_lm(jax.tree.map(np.asarray, qp), tcfg, device="cpu")
    prompts = [np.random.default_rng(60 + i).integers(0, tcfg.vocab, 12)
               .astype(np.int32) for i in range(2)]
    _serve_both(dataclasses.replace(rcfg, quant_serving=True),
                dataclasses.replace(tcfg, quant_serving=True), qp, qmodel,
                prompts, new=3)


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-2.7b"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "quant"])
def test_launch_serve_smoke_on_cpu(capsys, name, quant):
    from repro_torch.launch import serve

    done = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "12",
                       "--max-new", "3", "--slots", "2"]
                      + (["--quant"] if quant else []))
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out and "on cpu" in out
    assert ("C3 quantized serving: weight bytes" in out) == quant
