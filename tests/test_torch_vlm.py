"""The port's vlm family (phi-3-vision-4.2b) against the JAX package, on
the CPU.

phi-3-vision's SMOKE config at f32 (2 layers, d 64, 4 heads of hd 16, 8
patches), with the reference's `init_model(PRNGKey(0))` carried across by
`convert_lm`: prefill with and without `patch_embeds` (the patches go
before the text and occupy cache positions), decode after it, the
batched `Server` (zero patch embeddings, as the reference's stub
frontend), C3 prefill and decode, and `launch.serve`.  Logits and caches
within the LM tolerance of tests/test_torch_lm.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.convert import convert_lm
from repro_torch.kernels import ops
from repro_torch.models import attention as TATT
from repro_torch.models import transformer as TT
from repro_torch.quant import lm_quant as TQ
from repro_torch.serve import server as TS

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as RR  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.quant import lm_quant as RQ  # noqa: E402

NAME = "phi-3-vision-4.2b"
LOGIT_TOL = 1e-4     # tests/test_torch_lm.py's
SERVE_GAP = 1e-3     # fixture check: no top-2 logit gap below this
QUANT_MIN = 1 << 12  # the SMOKE leaves (2 layers of 64 x 64 and up) quantize


@pytest.fixture(scope="module")
def vlm():
    rcfg = dataclasses.replace(RR.get_arch(NAME, smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(TR.get_arch(NAME, smoke=True),
                               dtype=torch.float32)
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(0))
    model = convert_lm(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return rcfg, tcfg, params, model


def _batch(seed, b, s, cfg, patches=True):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if patches:
        out["patch_embeds"] = rng.normal(
            0, 1, (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _hold_kv(state, rstate):
    _close(state.kv.k, rstate.kv.k)
    _close(state.kv.v, rstate.kv.v)
    assert int(state.pos) == int(rstate.pos)


def test_config_is_the_reference_and_the_layer_is_dense(vlm):
    rcfg, tcfg, params, model = vlm
    assert TR.get_arch(NAME).hd == 96 and TR.get_arch(NAME).n_patches == 576
    assert set(model.blocks[0].leaves()) == set(params["blocks"])
    assert model.extras() == {}


@pytest.mark.parametrize("s,patches", [(12, True), (12, False),
                                       (248, True)],
                         ids=["patches", "text-only", "patches-flash-route"])
def test_forward_prefill_matches_reference(vlm, s, patches):
    """With patches, pos is n_patches + S and the patches' k / v fill the
    first cache positions; 8 patches + 248 tokens = 256 positions take
    the port's flash route (its plain version here)."""
    rcfg, tcfg, params, model = vlm
    batch = _batch(s, 2, s, tcfg, patches)
    n = s + (tcfg.n_patches if patches else 0)
    assert TATT._flash_ok(tcfg, n) == (n == 256)
    want, rst = RT.forward_prefill(params, rcfg, _jax(batch), n + 8)
    got, st = TT.forward_prefill(model, tcfg, _torch(batch), n + 8)
    _close(got, want)
    _hold_kv(st, rst)
    assert int(st.pos) == n


def test_decode_after_patched_prefill_matches_reference(vlm):
    rcfg, tcfg, params, model = vlm
    batch = _batch(3, 2, 16, tcfg)
    rb, tb = _jax(batch), _torch(batch)
    _, rst = RT.forward_prefill(params, rcfg, dict(rb, tokens=rb["tokens"][
        :, :12]), 32)
    _, st = TT.forward_prefill(model, tcfg, dict(tb, tokens=tb["tokens"][
        :, :12]), 32)
    for i in range(12, 16):
        want, rst = RT.forward_decode(params, rcfg, rst,
                                      rb["tokens"][:, i:i + 1])
        got, st = TT.forward_decode(model, tcfg, st, tb["tokens"][:, i:i + 1])
        _close(got, want)
        _hold_kv(st, rst)
    assert int(st.pos) == tcfg.n_patches + 16


def test_decode_continues_patched_prefill(vlm):
    """prefill(patches + S) equals prefill(patches + S - 1) then one
    decode step of the last token."""
    _, tcfg, _, model = vlm
    tb = _torch(_batch(4, 2, 20, tcfg))
    full, _ = TT.forward_prefill(model, tcfg, tb, 40)
    _, st = TT.forward_prefill(model, tcfg, dict(tb, tokens=tb["tokens"][
        :, :-1]), 40)
    got, _ = TT.forward_decode(model, tcfg, st, tb["tokens"][:, -1:])
    _close(got, full)


def test_prefill_raises_when_patches_and_prompt_overflow_the_cache(vlm):
    _, tcfg, _, model = vlm
    tb = _torch(_batch(5, 1, 12, tcfg))
    with pytest.raises(ValueError, match="does not fit a cache of 19"):
        TT.forward_prefill(model, tcfg, tb, tcfg.n_patches + 11)
    _, st = TT.forward_prefill(model, tcfg, tb, tcfg.n_patches + 12)
    assert int(st.pos) == tcfg.n_patches + 12


def _serve_both(rcfg, tcfg, rparams, tmodel, prompts, new=4, cache=40):
    from repro.launch.mesh import make_host_mesh
    from repro.serve.server import Request as RRequest
    from repro.serve.server import Server as RServer

    gaps = []

    def greedy(lg):
        top2 = np.sort(np.asarray(lg), axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        return jnp.argmax(lg, axis=-1)

    rsrv = RServer(rcfg, rparams, make_host_mesh(), batch_slots=2,
                   cache_len=cache)
    tsrv = TS.Server(tcfg, tmodel, device="cpu", batch_slots=2,
                     cache_len=cache)
    for i, pr in enumerate(prompts):
        rsrv.submit(RRequest(uid=i, prompt=pr, max_new_tokens=new))
        tsrv.submit(TS.Request(uid=i, prompt=pr, max_new_tokens=new))
    want = rsrv.run(sample=greedy)
    assert min(gaps) > SERVE_GAP          # the fixture has no near-tie
    got = tsrv.run()
    assert [r.uid for r in got] == [r.uid for r in want]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == new for r in got)


def test_server_tokens_equal_reference(vlm):
    """Both servers feed zero patch embeddings before each prompt."""
    rcfg, tcfg, params, model = vlm
    prompts = [np.random.default_rng(40 + i).integers(0, tcfg.vocab, 20)
               .astype(np.int32) for i in range(3)]
    _serve_both(rcfg, tcfg, params, model, prompts)


def test_server_feeds_zero_patches(vlm, monkeypatch):
    _, tcfg, _, model = vlm
    seen = []
    prefill = TT.forward_prefill

    def spy(params, cfg, batch, cache_len, param_transform=None):
        seen.append(batch["patch_embeds"])
        return prefill(params, cfg, batch, cache_len, param_transform)

    monkeypatch.setattr(TT, "forward_prefill", spy)
    srv = TS.Server(tcfg, model, device="cpu", batch_slots=2, cache_len=24)
    srv.submit(TS.Request(0, np.arange(1, 6, dtype=np.int32), 2))
    srv.run()
    assert len(seen) == 1 and seen[0].dtype == torch.float32
    assert tuple(seen[0].shape) == (1, tcfg.n_patches, tcfg.d_model)
    assert not bool(seen[0].any())


@pytest.fixture
def quant_min(monkeypatch):
    """The C3 threshold lowered in both packages, at runtime only."""
    monkeypatch.setattr(RQ, "_QUANT_MIN_SIZE", QUANT_MIN)
    monkeypatch.setattr(TQ, "_QUANT_MIN_SIZE", QUANT_MIN)


@pytest.mark.parametrize("pack", [False, True], ids=["int8", "4bit"])
def test_c3_prefill_and_decode_match_reference(vlm, quant_min, monkeypatch,
                                               pack):
    """The reference's quantized blocks carried across and served with
    each package's param_transform: the seven projections of a layer on
    the codebook product, per layer and forward."""
    rcfg, tcfg, params, _ = vlm
    qb = RQ.quantize_blocks(params["blocks"], pack_4bit=pack)
    quantized = {n for n, v in qb.items() if isinstance(v, dict)}
    assert quantized == {"wq", "wk", "wv", "wo", "mlp_wi", "mlp_wg",
                         "mlp_wo"}
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
    batch = _batch(6, 2, 14, tcfg)
    rb, tb = _jax(batch), _torch(batch)
    want, rst = RT.forward_prefill(qp, rcfg, dict(rb, tokens=rb["tokens"][
        :, :12]), 32, param_transform=rpt)
    got, st = TT.forward_prefill(qmodel, tcfg, dict(tb, tokens=tb["tokens"][
        :, :12]), 32, param_transform=tpt)
    _close(got, want)
    _hold_kv(st, rst)
    per_pass = len(quantized) * tcfg.n_layers
    assert len(calls) == per_pass
    for i in (12, 13):
        want, rst = RT.forward_decode(qp, rcfg, rst, rb["tokens"][:, i:i + 1],
                                      param_transform=rpt)
        got, st = TT.forward_decode(qmodel, tcfg, st,
                                    tb["tokens"][:, i:i + 1],
                                    param_transform=tpt)
        _close(got, want)
        _hold_kv(st, rst)
    assert len(calls) == 3 * per_pass


def test_c3_server_tokens_equal_reference(vlm, quant_min):
    """The port's own fit quantizes the seven projections; the quantized
    server gives the reference's tokens on the reference's quantized
    blocks."""
    from repro_torch.core.quant import CodebookConfig

    rcfg, tcfg, params, model = vlm
    q = TQ.quantize_blocks(model, CodebookConfig(16, 8, kmeans_iters=2))
    assert {n for n, v in q.blocks[0].leaves().items()
            if isinstance(v, dict)} == {"wq", "wk", "wv", "wo", "mlp_wi",
                                        "mlp_wg", "mlp_wo"}
    qp = dict(params, blocks=RQ.quantize_blocks(params["blocks"]))
    qmodel = convert_lm(jax.tree.map(np.asarray, qp), tcfg, device="cpu")
    prompts = [np.random.default_rng(70 + i).integers(0, tcfg.vocab, 12)
               .astype(np.int32) for i in range(2)]
    _serve_both(dataclasses.replace(rcfg, quant_serving=True),
                dataclasses.replace(tcfg, quant_serving=True), qp, qmodel,
                prompts, new=3)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "quant"])
def test_launch_serve_smoke_on_cpu(capsys, quant):
    from repro_torch.launch import serve

    done = serve.main(["--arch", NAME, "--smoke", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "12",
                       "--max-new", "3", "--slots", "2", "--cache-len", "32"]
                      + (["--quant"] if quant else []))
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out and "on cpu" in out
    assert ("C3 quantized serving: weight bytes" in out) == quant
