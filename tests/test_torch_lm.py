"""The port's LM serving path against the JAX package, on the CPU.

granite-3-2b's SMOKE config at f32 (2 layers, d 64, 4 heads, 2 kv heads,
hd 16; the moe family and C3 serving have test_torch_moe.py and
test_torch_lm_quant.py), with the reference's `init_model(PRNGKey(0))` carried across by
`convert_lm`: prefill on the flash route (S = 256, the kernel's plain
version here) and the plain route (S = 16), four decode steps, the
batched `Server`, the `launch.serve` entry point, and the pieces below
them (norm, RoPE, SwiGLU, chunked / ring-buffer / int8-cache attention).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.convert import convert_lm
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as TATT
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.serve import server as TS

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as RR  # noqa: E402
from repro.models import attention as RATT  # noqa: E402
from repro.models import common as RC  # noqa: E402
from repro.models import transformer as RT  # noqa: E402

# XLA and torch on the CPU differ by about 1e-5 on f32 matmuls (summation
# order); two layers, the unembedding and (on the flash route) an online
# against a one-pass softmax compound that to a few 1e-5 on logits of
# size ~1.
LOGIT_TOL = 1e-4
# one matmul and a norm: a few ulp
STEP_TOL = 1e-5
SERVE_GAP = 1e-3     # fixture check: no top-2 logit gap below this


def _cfgs():
    ref = dataclasses.replace(RR.get_arch("granite-3-2b", smoke=True),
                              dtype=jnp.float32)
    port = dataclasses.replace(TR.get_arch("granite-3-2b", smoke=True),
                               dtype=torch.float32)
    return ref, port


@pytest.fixture(scope="module")
def lm():
    rcfg, tcfg = _cfgs()
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(0))
    model = convert_lm(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return rcfg, tcfg, params, model


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


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["granite-3-2b", "granite-3-8b", "yi-9b",
                                  "mistral-large-123b",
                                  "granite-moe-1b-a400m",
                                  "moonshot-v1-16b-a3b", "mamba2-130m",
                                  "zamba2-2.7b", "whisper-tiny",
                                  "phi-3-vision-4.2b"])
def test_served_configs_equal_reference(name):
    for smoke in (False, True):
        r, t = RR.get_arch(name, smoke), TR.get_arch(name, smoke)
        rf = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        assert rf.pop("dtype") == jnp.bfloat16 and tf.pop("dtype") == \
            torch.bfloat16
        assert rf == tf
        assert r.param_count() == t.param_count() and r.hd == t.hd
    assert TR.ARCH_NAMES == RR.ARCH_NAMES
    assert TR.get_shape("decode_32k") == TC.SHAPES["decode_32k"]


@pytest.mark.parametrize("quant", [True, "4bit"])
def test_quant_serving_config_inits_the_same_model(quant):
    """`quant_serving` selects the serving hook, not the weights: the
    model it inits is the unquantized one of the same seed."""
    _, tcfg = _cfgs()
    q = TT.init_model(dataclasses.replace(tcfg, quant_serving=quant),
                      torch.Generator().manual_seed(0))
    want = TT.init_model(tcfg, torch.Generator().manual_seed(0))
    got = dict(q.named_parameters())
    assert got.keys() == dict(want.named_parameters()).keys()
    for name, t in want.named_parameters():
        assert torch.equal(got[name], t), name


def test_init_model_names_shapes_and_scales(lm):
    _, tcfg, rp, _ = lm
    model = TT.init_model(tcfg, torch.Generator().manual_seed(0))
    names = {n for n, _ in model.named_parameters()}
    want = {"embed", "unembed", "final_norm"} | {
        f"blocks.{i}.{k}" for i in range(tcfg.n_layers) for k in rp["blocks"]}
    assert names == want
    for name, t in model.named_parameters():
        parts = name.split(".")
        r = rp[name] if len(parts) == 1 else rp["blocks"][parts[2]][
            int(parts[1])]
        assert tuple(t.shape) == r.shape and t.dtype == torch.float32
    # the reference's scales: fan_in^-0.5, embed 1, wo / mlp_wo / (2L)^0.5
    big = dataclasses.replace(tcfg, d_model=256, d_ff=512, n_heads=8,
                              n_kv_heads=4)
    m = TT.init_model(big, torch.Generator().manual_seed(1))
    blk = m.blocks[0]
    L = big.n_layers
    for t, std in ((m.embed, 1.0), (blk["wq"], 256 ** -0.5),
                   (blk["wo"], 256 ** -0.5 / (2 * L) ** 0.5),
                   (blk["mlp_wo"], 512 ** -0.5 / (2 * L) ** 0.5)):
        assert abs(float(t.detach().std()) / std - 1) < 0.05
    assert torch.equal(blk["ln1"], torch.ones(256))


def test_convert_lm_carries_bf16_bit_for_bit():
    rcfg = RR.get_arch("granite-3-2b", smoke=True)          # bf16
    tcfg = TR.get_arch("granite-3-2b", smoke=True)
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(3))
    npp = jax.tree.map(np.asarray, params)
    model = convert_lm(npp, tcfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    for name, t in model.named_parameters():
        parts = name.split(".")
        r = npp[name] if len(parts) == 1 else npp["blocks"][parts[2]][
            int(parts[1])]
        assert r.dtype.name == "bfloat16"
        assert np.array_equal(t.detach().view(torch.int16).numpy(),
                              np.ascontiguousarray(r).view(np.int16)), name


def test_convert_lm_rejects_wrong_layers():
    rcfg, tcfg = _cfgs()
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="layers"):
        convert_lm(npp, dataclasses.replace(tcfg, n_layers=3), device="cpu")
    npp["blocks"]["wq"] = npp["blocks"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        convert_lm(npp, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# primitives and attention pieces
# ---------------------------------------------------------------------------

def test_rms_norm_rope_swiglu_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 12, 4, 16)).astype(np.float32)
    w = rng.normal(1, 0.1, 16).astype(np.float32)
    pos = np.arange(12)[None, :] + 5
    _close(TC.rms_norm(torch.tensor(x), torch.tensor(w)),
           RC.rms_norm(jnp.asarray(x), jnp.asarray(w)), STEP_TOL)
    _close(TC.apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0),
           RC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
           STEP_TOL)
    xb = x.reshape(2, 12, 64)
    ws = [rng.normal(0, 0.1, s).astype(np.float32)
          for s in ((64, 32), (64, 32), (32, 64))]
    _close(TC.swiglu(torch.tensor(xb), *map(torch.tensor, ws)),
           RC.swiglu(jnp.asarray(xb), *map(jnp.asarray, ws)), STEP_TOL)


def _attn_params(rng, cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {n: rng.normal(0, 0.1, s).astype(np.float32) for n, s in
            (("wq", (d, h * hd)), ("wk", (d, kv * hd)), ("wv", (d, kv * hd)),
             ("wo", (h * hd, d)))}


def test_chunked_attention_matches_reference():
    rcfg, tcfg = _cfgs()
    rcfg = dataclasses.replace(rcfg, attn_chunk=32, sliding_window=40)
    tcfg = dataclasses.replace(tcfg, attn_chunk=32, sliding_window=40)
    rng = np.random.default_rng(1)
    p = _attn_params(rng, tcfg)
    x = rng.normal(0, 1, (2, 96, 64)).astype(np.float32)
    got = TATT.attention_train(torch.tensor(x),
                               {k: torch.tensor(a) for k, a in p.items()},
                               tcfg)
    want = RATT.attention_train(jnp.asarray(x), p, rcfg)
    _close(got, want, STEP_TOL)


@pytest.mark.parametrize("window,kv_dtype", [(0, None), (0, "int8"),
                                             (6, None)],
                         ids=["plain", "int8-cache", "ring-buffer"])
def test_attention_decode_matches_reference(window, kv_dtype):
    """Eight decode steps from an empty cache; with a window of 6 over a
    cache of 6 slots, writes wrap around (the ring buffer)."""
    rcfg, tcfg = _cfgs()
    rcfg = dataclasses.replace(
        rcfg, sliding_window=window,
        kv_cache_dtype=jnp.int8 if kv_dtype else None)
    tcfg = dataclasses.replace(
        tcfg, sliding_window=window,
        kv_cache_dtype=torch.int8 if kv_dtype else None)
    rng = np.random.default_rng(2)
    p = _attn_params(rng, tcfg)
    tp = {k: torch.tensor(a) for k, a in p.items()}
    t = 6 if window else 12
    dt = np.int8 if kv_dtype else np.float32
    rc = RATT.KVCache(jnp.zeros((2, 2, t, 16), dt), jnp.zeros((2, 2, t, 16),
                                                             dt))
    tc = TATT.KVCache(torch.tensor(np.asarray(rc.k)),
                      torch.tensor(np.asarray(rc.v)))
    for step in range(8):
        x = rng.normal(0, 1, (2, 1, 64)).astype(np.float32)
        want, rc = RATT.attention_decode(jnp.asarray(x), p, rcfg, rc,
                                         jnp.asarray(step, jnp.int32))
        got, tc = TATT.attention_decode(torch.tensor(x), tp, tcfg, tc,
                                        torch.tensor(step, dtype=torch.int32))
        _close(got, want, STEP_TOL)
        if kv_dtype:      # rounding to the int8 grid may flip at a half step
            assert np.abs(tc.k.numpy().astype(int)
                          - np.asarray(rc.k).astype(int)).max() <= 1
        else:
            _close(tc.k, rc.k, STEP_TOL)
            _close(tc.v, rc.v, STEP_TOL)


def test_attn_mlp_block_matches_reference(lm):
    """S = 256: the port's flash route against the reference's one-pass
    SDPA (its flash route is held in the prefill test below)."""
    rcfg, tcfg, params, model = lm
    x = np.random.default_rng(4).normal(0, 1, (1, 256, 64)).astype(
        np.float32)
    lp = jax.tree.map(lambda a: a[0], params["blocks"])
    want, _ = RT._attn_mlp_block(jnp.asarray(x), lp, rcfg, moe=False)
    FA.reset_launches()
    with torch.no_grad():
        got, _ = TT._attn_mlp_block(torch.tensor(x), model.blocks[0], tcfg)
    _close(got, want, LOGIT_TOL)
    assert FA.launches["flash_attention"] == 0


# ---------------------------------------------------------------------------
# the model: prefill (both routes) and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,flash", [(256, True), (256, False), (16, False)],
                         ids=["S256-ref-flash", "S256-ref-plain",
                              "S16-plain"])
def test_forward_prefill_matches_reference(lm, flash_env, s, flash):
    """S = 256 takes the port's flash route (its plain version here); the
    reference's with REPRO_FLASH_ATTENTION=1 (the Pallas kernel in
    interpret mode) and without (one-pass SDPA).  S = 16 is the plain
    route in both."""
    rcfg, tcfg, params, model = lm
    flash_env(flash)
    assert TATT._flash_ok(tcfg, s) == (s == 256)
    assert RATT._flash_ok(rcfg, s) == (flash and s == 256)
    toks = _tokens(s, 2, s, tcfg.vocab)
    want, rstate = RT.forward_prefill(params, rcfg,
                                      {"tokens": jnp.asarray(toks)}, s + 8)
    got, state = TT.forward_prefill(model, tcfg,
                                    {"tokens": torch.tensor(toks)}, s + 8)
    _close(got, want, LOGIT_TOL)
    _close(state.kv.k, rstate.kv.k, LOGIT_TOL)
    _close(state.kv.v, rstate.kv.v, LOGIT_TOL)
    assert int(state.pos) == int(rstate.pos) == s


def test_four_decode_steps_match_reference(lm):
    rcfg, tcfg, params, model = lm
    toks = _tokens(11, 2, 20, tcfg.vocab)
    _, rst = RT.forward_prefill(params, rcfg,
                                {"tokens": jnp.asarray(toks[:, :16])}, 24)
    _, st = TT.forward_prefill(model, tcfg,
                               {"tokens": torch.tensor(toks[:, :16])}, 24)
    for i in range(16, 20):
        want, rst = RT.forward_decode(params, rcfg, rst,
                                      jnp.asarray(toks[:, i:i + 1]))
        got, st = TT.forward_decode(model, tcfg, st,
                                    torch.tensor(toks[:, i:i + 1]))
        _close(got, want, LOGIT_TOL)
        _close(st.kv.k, rst.kv.k, LOGIT_TOL)
        _close(st.kv.v, rst.kv.v, LOGIT_TOL)
        assert int(st.pos) == int(rst.pos) == i + 1


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_init_decode_state_matches_reference(kv_dtype):
    rcfg, tcfg = _cfgs()
    rcfg = dataclasses.replace(rcfg,
                               kv_cache_dtype=jnp.int8 if kv_dtype else None)
    tcfg = dataclasses.replace(
        tcfg, kv_cache_dtype=torch.int8 if kv_dtype else None)
    want = RT.init_decode_state(rcfg, 3, 20)
    got = TT.init_decode_state(tcfg, 3, 20, device="cpu")
    for g, w in ((got.kv.k, want.kv.k), (got.kv.v, want.kv.v)):
        assert tuple(g.shape) == w.shape and not bool(g.any())
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert int(got.pos) == int(want.pos) == 0 and got.pos.dtype == torch.int32
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_decode_state(tcfg, 3, 20)          # the card by default


def test_decode_continues_flash_prefill(lm):
    """The reference's own property (tests/test_models.py): prefill over
    S + 1 tokens equals prefill over S then one decode step; here S + 1 =
    256 takes the flash route and S = 255 the plain one."""
    _, tcfg, _, model = lm
    toks = torch.tensor(_tokens(12, 2, 256, tcfg.vocab))
    full, _ = TT.forward_prefill(model, tcfg, {"tokens": toks}, 264)
    _, st = TT.forward_prefill(model, tcfg, {"tokens": toks[:, :255]}, 264)
    got, st = TT.forward_decode(model, tcfg, st, toks[:, 255:])
    _close(got, full, LOGIT_TOL)
    assert int(st.pos) == 256


# ---------------------------------------------------------------------------
# the server and the entry point
# ---------------------------------------------------------------------------

def test_server_tokens_equal_reference(lm):
    from repro.launch.mesh import make_host_mesh
    from repro.serve.server import Request as RRequest
    from repro.serve.server import Server as RServer

    rcfg, tcfg, params, model = lm
    prompts = [np.random.default_rng(20 + i).integers(0, tcfg.vocab, 256)
               .astype(np.int32) for i in range(3)]
    gaps = []

    def greedy(lg):
        top2 = np.sort(np.asarray(lg), axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        return jnp.argmax(lg, axis=-1)

    rsrv = RServer(rcfg, params, make_host_mesh(), batch_slots=2,
                   cache_len=264)
    tsrv = TS.Server(tcfg, model, device="cpu", batch_slots=2,
                     cache_len=264)
    for i, pr in enumerate(prompts):
        rsrv.submit(RRequest(uid=i, prompt=pr, max_new_tokens=4))
        tsrv.submit(TS.Request(uid=i, prompt=pr, max_new_tokens=4))
    want = rsrv.run(sample=greedy)
    assert min(gaps) > SERVE_GAP          # the fixture has no near-tie
    got = tsrv.run()
    assert [r.uid for r in got] == [r.uid for r in want] == [0, 1, 2]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == 4 for r in got)


def test_server_left_pads_mixed_lengths(lm):
    """Prompts of 5 and 9 tokens share one left-padded batch (token 0, no
    mask), as the reference's server pads them."""
    _, tcfg, _, model = lm
    srv = TS.Server(tcfg, model, device="cpu", batch_slots=2, cache_len=16)
    short = np.arange(1, 6, dtype=np.int32)
    srv.submit(TS.Request(0, short, max_new_tokens=2))
    srv.submit(TS.Request(1, np.arange(1, 10, dtype=np.int32), 2))
    got = srv.run()
    padded = np.zeros((1, 9), np.int32)
    padded[0, 4:] = short
    lg, _ = TT.forward_prefill(model, tcfg, {"tokens": torch.tensor(padded)},
                               16)
    assert got[0].out_tokens[0] == int(torch.argmax(lg[0]))


def test_server_rejects_wrong_device_and_serves_quant(lm):
    """The SMOKE model has no leaf the reference would quantize (each is
    below 2^16 weights over its 2 layers), so `quantize_blocks` returns
    it unchanged and the quant_serving server gives the same tokens."""
    from repro_torch.quant import lm_quant as TQ

    _, tcfg, _, model = lm
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.Server(tcfg, model)                     # the card by default
    qmodel = TQ.quantize_blocks(model)
    assert not any(isinstance(v, dict) for b in qmodel.blocks
                   for v in b.leaves().values())
    prompt = np.arange(1, 13, dtype=np.int32)
    out = []
    for cfg, m in ((tcfg, model),
                   (dataclasses.replace(tcfg, quant_serving=True), qmodel)):
        srv = TS.Server(cfg, m, device="cpu", batch_slots=2, cache_len=16)
        srv.submit(TS.Request(0, prompt, max_new_tokens=3))
        out.append(srv.run()[0].out_tokens)
    assert out[0] == out[1] and len(out[0]) == 3


def test_launch_serve_smoke_on_cpu(capsys):
    from repro_torch.launch import serve

    done = serve.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "12",
                       "--max-new", "3", "--slots", "2"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out and "on cpu" in out
    done = serve.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-new", "2", "--quant"])
    out = capsys.readouterr().out
    assert "C3 quantized serving: weight bytes" in out
    assert len(done) == 2 and all(len(r.out_tokens) == 2 for r in done)
