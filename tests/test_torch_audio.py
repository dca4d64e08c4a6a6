"""The port's audio family (whisper: encoder, cross-attention) against the
JAX package, on the CPU.

Fixtures at f32: the reference's own `tiny("audio")` (tests/test_models.py:
2 + 2 layers, d 64, 4 heads, 12 frames) and whisper-tiny's SMOKE config
(16 frames), each with the reference's `init_model(PRNGKey(0))` carried
across by `convert_lm`.  `attention_encoder`, `attention_cross`, the
encoder stack, prefill with its caches and `enc_out`, the decoder prefill
at S = 256 on the port's flash route (its plain version here) against the
reference with and without `REPRO_FLASH_ATTENTION=1`, four decode steps,
the batched `Server` (zero frames, as both servers feed the stub
frontend), C3 serving of the reference's quantized blocks (the
quantization threshold lowered in both packages, so that all eleven 2-D
products of a decoder layer quantize), and `launch.serve`.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.convert import convert_lm
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import attention as TATT
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.quant import lm_quant as TQ
from repro_torch.serve import server as TS

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as RR  # noqa: E402
from repro.models import attention as RATT  # noqa: E402
from repro.models import common as RC  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.quant import lm_quant as RQ  # noqa: E402

STEP_TOL = 1e-5      # one attention: a few ulp
LOGIT_TOL = 1e-4     # whole models, C3 (as tests/test_torch_lm.py)
SERVE_GAP = 1e-3     # fixture check: no top-2 logit gap below this
QUANT_MIN = 1 << 10  # C3 threshold here: every 2-D product quantizes
PRODUCTS = ("wq", "wk", "wv", "wo", "xwq", "xwk", "xwv", "xwo", "mlp_wi",
            "mlp_wg", "mlp_wo")

FIXTURES = ("audio", "whisper-tiny")


def _cfgs(fixture):
    """The fixture as the reference's and the port's f32 ArchConfig."""
    if fixture == "whisper-tiny":
        return (dataclasses.replace(RR.get_arch(fixture, smoke=True),
                                    dtype=jnp.float32),
                dataclasses.replace(TR.get_arch(fixture, smoke=True),
                                    dtype=torch.float32))
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                vocab=97, enc_layers=2, enc_frames=12)
    return (RC.ArchConfig("audio-t", "audio", dtype=jnp.float32, **base),
            TC.ArchConfig("audio-t", "audio", dtype=torch.float32, **base))


@functools.cache
def _setup(fixture):
    rcfg, tcfg = _cfgs(fixture)
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(0))
    return rcfg, tcfg, params, convert_lm(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")


@pytest.fixture
def flash_env(monkeypatch):
    """Sets REPRO_FLASH_ATTENTION for the reference, undone afterwards."""
    def set_flash(on: bool):
        if on:
            monkeypatch.setenv("REPRO_FLASH_ATTENTION", "1")
        else:
            monkeypatch.delenv("REPRO_FLASH_ATTENTION", raising=False)
        RATT._flash_enabled.cache_clear()
    yield set_flash
    monkeypatch.delenv("REPRO_FLASH_ATTENTION", raising=False)
    RATT._flash_enabled.cache_clear()


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _frames(seed, cfg, b=2):
    return np.random.default_rng(seed).normal(
        0, 1, (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def _batch(toks, frames, torch_side: bool):
    if torch_side:
        return {"tokens": torch.tensor(toks), "frames": torch.tensor(frames)}
    return {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _leaves(block):
    return {k: v.detach() for k, v in block.leaves().items()}


# ---------------------------------------------------------------------------
# init and conversion
# ---------------------------------------------------------------------------

def test_init_model_names_shapes_and_scales():
    rcfg, tcfg = _cfgs("whisper-tiny")
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(1))
    model = TT.init_model(tcfg, torch.Generator().manual_seed(1))
    assert set(model.blocks[0].leaves()) == set(params["blocks"]) == (
        set(PRODUCTS) | {"ln1", "ln_x", "ln2"})
    assert len(model.encoder) == tcfg.enc_layers
    for name, w in params["encoder"].items():
        assert tuple(model.encoder[0][name].shape) == w.shape[1:], name
    for name, w in params["blocks"].items():
        assert tuple(model.blocks[0][name].shape) == w.shape[1:], name
    assert model.enc_final_norm.shape == params["enc_final_norm"].shape
    assert model.shared_attn is None
    big = dataclasses.replace(tcfg, d_model=256, n_heads=4, n_kv_heads=4,
                              n_layers=3, enc_layers=2)
    m = TT.init_model(big, torch.Generator().manual_seed(2))
    for t, std in ((m.blocks[0]["xwq"], 256 ** -0.5),
                   (m.blocks[0]["xwo"], 256 ** -0.5),      # no depth scale
                   (m.blocks[0]["wo"], 256 ** -0.5 / 6 ** 0.5),
                   (m.encoder[0]["wo"], 256 ** -0.5 / 4 ** 0.5)):
        assert abs(float(t.detach().std()) / std - 1) < 0.05


def test_convert_lm_carries_the_encoder_bf16_bit_for_bit():
    tcfg = TR.get_arch("whisper-tiny", smoke=True)        # bf16
    npp = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                       _setup("whisper-tiny")[2])
    model = convert_lm(npp, tcfg, device="cpu")
    names = dict(model.named_parameters())
    assert sum(n.startswith("encoder.") for n in names) == (
        tcfg.enc_layers * len(npp["encoder"]))
    for name, t in names.items():
        parts = name.split(".")
        if parts[0] in ("blocks", "encoder"):
            r = npp[parts[0]][parts[2]][int(parts[1])]
        else:
            r = npp[name]
        assert t.dtype == torch.bfloat16, name
        assert np.array_equal(t.detach().view(torch.int16).numpy(),
                              np.ascontiguousarray(r).view(np.int16)), name
    npp["encoder"]["wq"] = npp["encoder"]["wq"][:1]
    with pytest.raises(ValueError, match="encoder"):
        convert_lm(npp, tcfg, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        TT.Transformer(tcfg, model.embed, model.unembed, model.final_norm,
                       [b.leaves() for b in model.blocks])


# ---------------------------------------------------------------------------
# the attention pieces and the encoder
# ---------------------------------------------------------------------------

def test_attention_encoder_and_cross_match_reference():
    rcfg, tcfg, params, model = _setup("audio")
    rng = np.random.default_rng(3)
    lp = jax.tree.map(lambda a: a[1], params["blocks"])
    tp = _leaves(model.blocks[1])
    x = rng.normal(0, 1, (2, 10, 64)).astype(np.float32)
    enc = rng.normal(0, 1, (2, 12, 64)).astype(np.float32)
    _close(TATT.attention_encoder(torch.tensor(x), tp, tcfg),
           RATT.attention_encoder(jnp.asarray(x), lp, rcfg), STEP_TOL)
    _close(TATT.attention_cross(torch.tensor(x), torch.tensor(enc), tp, tcfg),
           RATT.attention_cross(jnp.asarray(x), jnp.asarray(enc), lp, rcfg),
           STEP_TOL)
    # one query row (decode) against the encoder
    _close(TATT.attention_cross(torch.tensor(x[:, :1]), torch.tensor(enc),
                                tp, tcfg),
           RATT.attention_cross(jnp.asarray(x[:, :1]), jnp.asarray(enc), lp,
                                rcfg), STEP_TOL)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_encoder_forward_matches_reference(fixture):
    rcfg, tcfg, params, model = _setup(fixture)
    frames = _frames(4, tcfg)
    with torch.no_grad():
        got = TT._encoder_forward(model, tcfg, torch.tensor(frames))
    _close(got, RT._encoder_forward(params, rcfg, jnp.asarray(frames)),
           LOGIT_TOL)


# ---------------------------------------------------------------------------
# the model: prefill (both routes) and decode
# ---------------------------------------------------------------------------

def _hold_state(got, want, tol=LOGIT_TOL):
    _close(got.kv.k, want.kv.k, tol)
    _close(got.kv.v, want.kv.v, tol)
    _close(got.enc_out, want.enc_out, tol)
    assert got.ssm == () and got.shared_kv == ()
    assert int(got.pos) == int(want.pos)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_forward_prefill_matches_reference(fixture):
    rcfg, tcfg, params, model = _setup(fixture)
    toks, frames = _tokens(13, 2, 13, tcfg.vocab), _frames(13, tcfg)
    want, rst = RT.forward_prefill(params, rcfg, _batch(toks, frames, False),
                                   24)
    got, st = TT.forward_prefill(model, tcfg, _batch(toks, frames, True), 24)
    _close(got, want, LOGIT_TOL)
    _hold_state(st, rst)


@pytest.mark.parametrize("flash", [True, False],
                         ids=["ref-flash", "ref-plain"])
def test_decoder_prefill_on_the_flash_route(flash_env, flash):
    """whisper SMOKE at S = 256: the port's decoder self-attention takes
    the flash route (its plain version here), once per decoder layer; the
    encoder and cross-attention never do.  The reference with
    REPRO_FLASH_ATTENTION=1 (the Pallas kernel in interpret mode) and
    without (one-pass SDPA)."""
    rcfg, tcfg, params, model = _setup("whisper-tiny")
    flash_env(flash)
    assert TATT._flash_ok(tcfg, 256) and RATT._flash_ok(rcfg, 256) == flash
    toks, frames = _tokens(256, 1, 256, tcfg.vocab), _frames(256, tcfg, 1)
    want, rst = RT.forward_prefill(params, rcfg, _batch(toks, frames, False),
                                   264)
    calls = []
    flash_fn = TATT.flash_attention

    def spy(q, k, v, causal=True):
        calls.append(tuple(q.shape))
        return flash_fn(q, k, v, causal=causal)

    TATT.flash_attention = spy
    try:
        got, st = TT.forward_prefill(model, tcfg, _batch(toks, frames, True),
                                     264)
    finally:
        TATT.flash_attention = flash_fn
    assert calls == [(1, tcfg.n_heads, 256, tcfg.hd)] * tcfg.n_layers
    _close(got, want, LOGIT_TOL)
    _hold_state(st, rst)
    assert FA.launches["flash_attention"] == 0          # no card here


@pytest.mark.parametrize("fixture", FIXTURES)
def test_four_decode_steps_match_reference(fixture):
    rcfg, tcfg, params, model = _setup(fixture)
    toks, frames = _tokens(11, 2, 17, tcfg.vocab), _frames(11, tcfg)
    _, rst = RT.forward_prefill(params, rcfg,
                                _batch(toks[:, :13], frames, False), 24)
    _, st = TT.forward_prefill(model, tcfg, _batch(toks[:, :13], frames, True),
                               24)
    for i in range(13, 17):
        want, rst = RT.forward_decode(params, rcfg, rst,
                                      jnp.asarray(toks[:, i:i + 1]))
        got, st = TT.forward_decode(model, tcfg, st,
                                    torch.tensor(toks[:, i:i + 1]))
        _close(got, want, LOGIT_TOL)
        _hold_state(st, rst)


def test_decode_continues_prefill():
    """prefill over S + 1 tokens equals prefill over S then one decode
    step, the same frames."""
    _, tcfg, _, model = _setup("audio")
    toks, frames = _tokens(12, 2, 17, tcfg.vocab), _frames(12, tcfg)
    full, _ = TT.forward_prefill(model, tcfg, _batch(toks, frames, True), 24)
    _, st = TT.forward_prefill(model, tcfg, _batch(toks[:, :16], frames,
                                                   True), 24)
    got, st = TT.forward_decode(model, tcfg, st, torch.tensor(toks[:, 16:]))
    _close(got, full, LOGIT_TOL)
    assert int(st.pos) == 17


def test_init_decode_state_matches_reference():
    rcfg = RR.get_arch("whisper-tiny", smoke=True)        # bf16
    tcfg = TR.get_arch("whisper-tiny", smoke=True)
    want = RT.init_decode_state(rcfg, 3, 20)
    got = TT.init_decode_state(tcfg, 3, 20, device="cpu")
    for g, w in ((got.kv.k, want.kv.k), (got.kv.v, want.kv.v),
                 (got.enc_out, want.enc_out)):
        assert tuple(g.shape) == w.shape and not bool(g.any())
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert got.ssm == () and got.shared_kv == () and int(got.pos) == 0


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


def test_server_tokens_equal_reference():
    rcfg, tcfg, params, model = _setup("audio")
    prompts = [np.random.default_rng(30 + i).integers(0, tcfg.vocab, 20)
               .astype(np.int32) for i in range(3)]
    _serve_both(rcfg, tcfg, params, model, prompts)


@pytest.fixture
def quant_min(monkeypatch):
    """The C3 threshold lowered in both packages, at runtime only."""
    monkeypatch.setattr(RQ, "_QUANT_MIN_SIZE", QUANT_MIN)
    monkeypatch.setattr(TQ, "_QUANT_MIN_SIZE", QUANT_MIN)


@pytest.mark.parametrize("pack", [False, True], ids=["int8", "4bit"])
def test_c3_prefill_and_decode_match_reference(pack, quant_min, monkeypatch):
    """The reference's quantized decoder blocks carried across and served
    with each package's param_transform: eleven codebook products per
    decoder layer and forward; the encoder stays unquantized."""
    rcfg, tcfg, params, _ = _setup("audio")
    qb = RQ.quantize_blocks(params["blocks"], pack_4bit=pack)
    assert {n for n, v in qb.items() if isinstance(v, dict)} == set(PRODUCTS)
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
    toks, frames = _tokens(5, 2, 15, tcfg.vocab), _frames(5, tcfg)
    want, rst = RT.forward_prefill(qp, rcfg, _batch(toks[:, :13], frames,
                                                    False), 24,
                                   param_transform=rpt)
    got, st = TT.forward_prefill(qmodel, tcfg, _batch(toks[:, :13], frames,
                                                      True), 24,
                                 param_transform=tpt)
    _close(got, want, LOGIT_TOL)
    _hold_state(st, rst)
    assert len(calls) == len(PRODUCTS) * tcfg.n_layers
    for i in (13, 14):
        want, rst = RT.forward_decode(qp, rcfg, rst, jnp.asarray(
            toks[:, i:i + 1]), param_transform=rpt)
        got, st = TT.forward_decode(qmodel, tcfg, st, torch.tensor(
            toks[:, i:i + 1]), param_transform=tpt)
        _close(got, want, LOGIT_TOL)
        _hold_state(st, rst)
    assert len(calls) == 3 * len(PRODUCTS) * tcfg.n_layers


def test_quantize_blocks_keeps_the_encoder(quant_min):
    from repro_torch.core.quant import CodebookConfig

    _, _, _, model = _setup("audio")
    q = TQ.quantize_blocks(model, CodebookConfig(16, 8, kmeans_iters=2))
    assert {n for n, v in q.blocks[0].leaves().items()
            if isinstance(v, dict)} == set(PRODUCTS)
    assert torch.equal(q.enc_final_norm, model.enc_final_norm)
    for got, want in zip(q.encoder, model.encoder):
        assert got.leaves().keys() == want.leaves().keys()
        for name, t in want.leaves().items():
            assert torch.equal(got[name], t), name


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "quant"])
def test_launch_serve_smoke_on_cpu(capsys, quant):
    from repro_torch.launch import serve

    done = serve.main(["--arch", "whisper-tiny", "--smoke", "--device",
                       "cpu", "--requests", "3", "--prompt-len", "12",
                       "--max-new", "3", "--slots", "2"]
                      + (["--quant"] if quant else []))
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out and "on cpu" in out
    assert ("C3 quantized serving: weight bytes" in out) == quant
