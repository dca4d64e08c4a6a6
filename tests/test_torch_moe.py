"""The port's moe family against the JAX package, on the CPU.

The reference's own fixture (tests/test_models.py `tiny("moe", ...)`, f32,
capacity factor 4 so no token drops) with `init_model(PRNGKey(0))`
carried across by `convert_lm`, and the two registered moe SMOKE configs
(granite-moe-1b-a400m, moonshot-v1-16b-a3b) at f32: `top_k_dispatch`
bitwise, with and without capacity drops and with tied router
probabilities; `moe_ffn` and its aux loss; the block; prefill on the
flash route (S = 256, the kernel's plain version here) and the plain
route (S = 16), four decode steps; init names and scales; the `Server`
and `launch.serve` entry points.
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
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.serve import server as TS

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as RR  # noqa: E402
from repro.models import common as RC  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import transformer as RT  # noqa: E402

LOGIT_TOL = 1e-4     # as tests/test_torch_lm.py: XLA and torch sum f32
FFN_TOL = 1e-5       # one router product, softmax and four einsums
SERVE_GAP = 1e-3     # fixture check: no top-2 logit gap below this
SMOKE_MOE = ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b"]


def _tiny(family="moe", **kw):
    """tests/test_models.py `tiny`, as the reference's and the port's
    ArchConfig."""
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=97)
    base.update(kw)
    return (RC.ArchConfig(f"{family}-t", family, dtype=jnp.float32, **base),
            TC.ArchConfig(f"{family}-t", family, dtype=torch.float32,
                          **base))


# the reference's moe fixture (tests/test_models.py CONFIGS)
TINY_MOE = dict(n_kv_heads=4, d_ff=32, n_experts=4, top_k=2,
                moe_group_size=32, capacity_factor=4.0)


def _smoke(name):
    return (dataclasses.replace(RR.get_arch(name, smoke=True),
                                dtype=jnp.float32),
            dataclasses.replace(TR.get_arch(name, smoke=True),
                                dtype=torch.float32))


def _model(rcfg, tcfg, seed=0):
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(seed))
    return params, convert_lm(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")


@pytest.fixture(scope="module", params=SMOKE_MOE)
def smoke_lm(request):
    rcfg, tcfg = _smoke(request.param)
    return (rcfg, tcfg) + _model(rcfg, tcfg)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# init and routing
# ---------------------------------------------------------------------------

def test_init_moe_names_shapes_and_scales():
    """The reference's leaves and shapes; scales d^-0.5 (router), E^-0.5
    for the expert stacks' default (fan_in = shape[0] of the 3-D shape),
    ff^-0.5 / (2L)^0.5 for moe_wo."""
    rcfg, tcfg = _tiny(**TINY_MOE)
    rp, _ = RT.init_model(rcfg, jax.random.PRNGKey(0))
    model = TT.init_model(tcfg, torch.Generator().manual_seed(0))
    blocks = {k: t for k, t in model.blocks[0].leaves().items()}
    assert set(blocks) == set(rp["blocks"])
    for name, t in blocks.items():
        assert tuple(t.shape) == rp["blocks"][name].shape[1:], name
    _, big = _tiny(d_model=256, d_ff=192, n_heads=8, n_kv_heads=4,
                   n_experts=16, top_k=2)
    blk = TT.init_model(big, torch.Generator().manual_seed(1)).blocks[0]
    L = big.n_layers
    for name, std in (("router", 256 ** -0.5), ("moe_wi", 16 ** -0.5),
                      ("moe_wg", 16 ** -0.5),
                      ("moe_wo", 192 ** -0.5 / (2 * L) ** 0.5)):
        assert abs(float(blk[name].detach().std()) / std - 1) < 0.05, name


@pytest.mark.parametrize("gs", [1, 4, 32, 256, 1000])
def test_capacity_matches_reference(gs):
    for kw in (TINY_MOE, dict(n_experts=32, top_k=8),
               dict(n_experts=64, top_k=6, capacity_factor=1.0)):
        rcfg, tcfg = _tiny(**kw)
        assert TMOE.capacity(tcfg, gs) == RMOE.capacity(rcfg, gs)


def _probs(seed, g, s, e, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1, (g, s, e)).astype(np.float32)
    if ties:                     # whole rows and leading pairs tied
        logits[:, ::5] = 0.0
        logits[:, 1::7, :2] = 3.0
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("cap,ties", [(32, False), (3, False), (3, True),
                                      (1, True)],
                         ids=["no-drops", "drops", "drops-ties",
                              "cap1-ties"])
def test_top_k_dispatch_equals_reference(cap, ties):
    probs = _probs(cap, 3, 16, 4, ties)
    rd, rc = RMOE.top_k_dispatch(jnp.asarray(probs), 2, cap)
    td, tc = TMOE.top_k_dispatch(torch.tensor(probs), 2, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    kept = float(td.sum())
    assert (kept == 3 * 16 * 2) == (cap == 32)      # drops where cap < 32


@pytest.mark.parametrize("kw", [TINY_MOE, dict(TINY_MOE, capacity_factor=1.0,
                                               moe_group_size=16)],
                         ids=["no-drops", "drops"])
def test_moe_ffn_matches_reference(kw):
    rcfg, tcfg = _tiny(**kw)
    params, model = _model(rcfg, tcfg)
    lp = jax.tree.map(lambda a: a[0], params["blocks"])
    x = np.random.default_rng(5).normal(0, 1, (2, 24, 64)).astype(
        np.float32)
    want, raux = RMOE.moe_ffn(jnp.asarray(x), lp, rcfg)
    got, aux = TMOE.moe_ffn(torch.tensor(x), model.blocks[0], tcfg)
    _close(got.detach(), want, FFN_TOL)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    _close(aux.detach(), raux, FFN_TOL)


def test_attn_mlp_block_returns_the_aux_loss():
    rcfg, tcfg = _tiny(**TINY_MOE)
    params, model = _model(rcfg, tcfg)
    lp = jax.tree.map(lambda a: a[1], params["blocks"])
    x = np.random.default_rng(6).normal(0, 1, (2, 16, 64)).astype(
        np.float32)
    want, raux = RT._attn_mlp_block(jnp.asarray(x), lp, rcfg, moe=True)
    with torch.no_grad():
        got, aux = TT._attn_mlp_block(torch.tensor(x), model.blocks[1], tcfg)
    _close(got, want, FFN_TOL)
    _close(aux, raux, FFN_TOL)


def test_moe_group_size_is_the_largest_divisor():
    """B * S = 2 * 21 = 42 tokens with a preferred group of 32: groups of
    21, as the reference's divisor loop picks."""
    rcfg, tcfg = _tiny(**TINY_MOE)
    params, model = _model(rcfg, tcfg)
    lp = jax.tree.map(lambda a: a[0], params["blocks"])
    x = np.random.default_rng(7).normal(0, 1, (2, 21, 64)).astype(
        np.float32)
    seen = []
    dispatch = TMOE.top_k_dispatch

    def spy(probs, k, cap):
        seen.append(tuple(probs.shape))
        return dispatch(probs, k, cap)

    TMOE.top_k_dispatch = spy
    try:
        got, _ = TMOE.moe_ffn(torch.tensor(x), model.blocks[0], tcfg)
    finally:
        TMOE.top_k_dispatch = dispatch
    assert seen == [(2, 21, 4)]
    want, _ = RMOE.moe_ffn(jnp.asarray(x), lp, rcfg)
    _close(got.detach(), want, FFN_TOL)


# ---------------------------------------------------------------------------
# the model: prefill (both routes) and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [256, 16], ids=["S256-flash", "S16-plain"])
def test_moe_prefill_matches_reference(smoke_lm, s):
    rcfg, tcfg, params, model = smoke_lm
    assert TATT._flash_ok(tcfg, s) == (s == 256)
    toks = _tokens(s, 2, s, tcfg.vocab)
    FA.reset_launches()
    want, rstate = RT.forward_prefill(params, rcfg,
                                      {"tokens": jnp.asarray(toks)}, s + 8)
    got, state = TT.forward_prefill(model, tcfg,
                                    {"tokens": torch.tensor(toks)}, s + 8)
    _close(got, want, LOGIT_TOL)
    _close(state.kv.k, rstate.kv.k, LOGIT_TOL)
    _close(state.kv.v, rstate.kv.v, LOGIT_TOL)
    assert int(state.pos) == int(rstate.pos) == s
    assert FA.launches["flash_attention"] == 0        # CPU: plain version


def test_moe_four_decode_steps_match_reference(smoke_lm):
    rcfg, tcfg, params, model = smoke_lm
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
        assert int(st.pos) == int(rst.pos) == i + 1


def test_moe_decode_continues_prefill():
    """The reference's own property on its fixture (no drops at capacity
    factor 4): prefill over S + 1 equals prefill over S then one decode
    step; S + 1 = 256 takes the flash route, S = 255 the plain one."""
    rcfg, tcfg = _tiny(**TINY_MOE)
    _, model = _model(rcfg, tcfg)
    toks = torch.tensor(_tokens(12, 2, 256, tcfg.vocab))
    full, _ = TT.forward_prefill(model, tcfg, {"tokens": toks}, 264)
    _, st = TT.forward_prefill(model, tcfg, {"tokens": toks[:, :255]}, 264)
    got, st = TT.forward_decode(model, tcfg, st, toks[:, 255:])
    _close(got, full, LOGIT_TOL)
    assert int(st.pos) == 256


def test_convert_lm_carries_moe_bf16_bit_for_bit():
    rcfg = RR.get_arch("granite-moe-1b-a400m", smoke=True)     # bf16
    tcfg = TR.get_arch("granite-moe-1b-a400m", smoke=True)
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(3))
    npp = jax.tree.map(np.asarray, params)
    model = convert_lm(npp, tcfg, device="cpu")
    names = set()
    for name, t in model.named_parameters():
        parts = name.split(".")
        r = npp[name] if len(parts) == 1 else npp["blocks"][parts[2]][
            int(parts[1])]
        names.add(parts[-1])
        assert t.dtype == torch.bfloat16 and r.dtype.name == "bfloat16"
        assert np.array_equal(t.detach().view(torch.int16).numpy(),
                              np.ascontiguousarray(r).view(np.int16)), name
    assert {"router", "moe_wi", "moe_wg", "moe_wo"} <= names
    assert not names & {"mlp_wi", "mlp_wg", "mlp_wo"}


# ---------------------------------------------------------------------------
# the server and the entry point
# ---------------------------------------------------------------------------

def test_moe_server_tokens_equal_reference(smoke_lm):
    from repro.launch.mesh import make_host_mesh
    from repro.serve.server import Request as RRequest
    from repro.serve.server import Server as RServer

    rcfg, tcfg, params, model = smoke_lm
    prompts = [np.random.default_rng(30 + i).integers(0, tcfg.vocab, 24)
               .astype(np.int32) for i in range(3)]
    gaps = []

    def greedy(lg):
        top2 = np.sort(np.asarray(lg), axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        return jnp.argmax(lg, axis=-1)

    rsrv = RServer(rcfg, params, make_host_mesh(), batch_slots=2,
                   cache_len=32)
    tsrv = TS.Server(tcfg, model, device="cpu", batch_slots=2, cache_len=32)
    for i, pr in enumerate(prompts):
        rsrv.submit(RRequest(uid=i, prompt=pr, max_new_tokens=4))
        tsrv.submit(TS.Request(uid=i, prompt=pr, max_new_tokens=4))
    want = rsrv.run(sample=greedy)
    assert min(gaps) > SERVE_GAP          # the fixture has no near-tie
    got = tsrv.run()
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


@pytest.mark.parametrize("name", SMOKE_MOE)
def test_launch_serve_moe_smoke_on_cpu(capsys, name):
    from repro_torch.launch import serve

    done = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "12",
                       "--max-new", "3", "--slots", "2"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out
