"""The sequence split through blocks whose heads the "model" axis does
not split, on the CPU.

The reference's rules keep the residual's sequence on "model"
(`"seq": ["model"]`), and where a block's heads do not divide that axis
its layout keeps the block's work split by sequence rows.  The port does
the same: a product whose weight that axis does not split runs on each
device's rows (`models/common.py` `linear`), attention runs each
device's query rows from their offset over the whole k / v
(`models/attention.py` `_on_local_heads`), the causal conv takes the
previous shard's last K - 1 rows as a halo, and the SSD scan runs each
device's chunks and folds in the shards before it
(`models/mamba2.py` `_conv_on_shards`, `_scan_by_chunks`).

gloo ranks spawned from the test (tests/torch_mesh_ranks.py) mesh
themselves data 1 x model 3: mamba2-130m's SMOKE config has 4 SSD heads
and whisper-tiny's 4 attention heads, so 3 leaves them unsplit.  Held:

* (a) the pieces against the reference's one-device functions in JAX
  (`_sdpa`, `_sdpa_chunked`, `_causal_conv_train`, `ssd_chunked`,
  `mamba2_forward` and its prefill cache) within STEP_TOL (one function)
  and SCAN_TOL (a scan or a layer) of the output's largest magnitude,
  their gradients against the port's one-device autograd within GRAD_TOL
  of the gradient's largest magnitude, and each output left split by
  sequence;
* the mesh's FLOPs a device for a mamba2 layer and an attention at most
  SPLIT_SHARE of one device's (the parent tree ran every chunk and every
  query row on every device), and the layer gathering nothing larger than
  the scan's per-shard summaries;
* (b) whole models on that mesh: two `make_train_step(mesh=...)` steps'
  loss and grad_norm within MESH_LOSS_REL / MESH_GNORM_REL of the
  one-device steps (chip_smoke.py's limits), and a prefill plus two
  greedy decode steps' logits within MESH_LOGIT_REL of their largest
  magnitude (tests/test_torch_mesh_serve.py's);
* a `Server(mesh=..., rules=...)` under rules that leave the heads
  unsplit (as the card's phase 17 (g), (h) serve): tokens equal and every
  step's logits within MESH_LOGIT_REL of the one-device server, the
  parameters laid out by those rules;
* (c) the flash route refuses query rows at an offset and still takes
  S == T.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.launch import steps as TST
from repro_torch.models import attention as TATT
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TA

sys.path.insert(0, str(Path(__file__).parent))
from torch_mesh_ranks import spawn_mesh_ranks  # noqa: E402

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as RR  # noqa: E402
from repro.models import attention as RATT  # noqa: E402
from repro.models import mamba2 as RM  # noqa: E402

MODEL = 3                # the "model" axis: divides neither SMOKE's 4 heads
B = 2
S_ATT = 24               # 8 query rows a device
T_ENC = 16               # full attention's k / v length (unsplit)
S_SSM = 48               # two chunks of 8 a device
ATT_CHUNK = 4            # the query-chunked route, 2 chunks a device
STEP_TOL = 1e-5          # one function, of the largest magnitude (as
                         # tests/test_torch_ssm.py)
SCAN_TOL = 1e-4          # a scan or a layer: reassociated recurrence
GRAD_TOL = 1e-4          # gradients against the port's one device
SPLIT_SHARE = 0.4        # FLOPs a device over one device's, 3 devices
MESH_LOSS_REL = 1e-4     # chip_smoke.py's meshed step 0 limits
MESH_GNORM_REL = 1e-3
MESH_LOGIT_REL = 1e-5    # tests/test_torch_mesh_serve.py's LOGIT_REL
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
MODELS = {"mamba2-130m": (S_SSM, {}),
          "whisper-tiny": (S_ATT, {"enc_frames": S_ATT})}
# a Server under rules that leave the heads unsplit (the rules the card's
# phase 17 (g), (h) serve under): whisper-tiny's SMOKE config at 6 heads,
# which would divide the model axis of 3 under the default rules
SEQ_RULES = {"heads": [], "kv_heads": []}
SERVED = dict(arch="whisper-tiny", cfg={"n_heads": 6, "n_kv_heads": 6,
                                        "d_model": 96, "enc_frames": S_ATT},
              slots=2, cache_len=S_ATT + 4, new=3)


def _cfg(arch, **kw):
    return dataclasses.replace(TR.get_arch(arch, smoke=True),
                               dtype=torch.float32, **kw)


def _rcfg(arch, **kw):
    return dataclasses.replace(RR.get_arch(arch, smoke=True),
                               dtype=jnp.float32, **kw)


def _normal(rng, shape, scale=1.0):
    return torch.tensor(rng.normal(0, scale, shape).astype(np.float32))


def _inputs():
    rng = np.random.default_rng(0)
    acfg, mcfg = _cfg("whisper-tiny"), _cfg("mamba2-130m")
    h, hd = acfg.n_heads, acfg.hd
    d_in, nh, n, hp = TM.dims(mcfg)
    ch = TM.conv_channels(mcfg)
    attention = {"q": _normal(rng, (B, S_ATT, h, hd)),
                 "k": _normal(rng, (B, S_ATT, h, hd)),
                 "v": _normal(rng, (B, S_ATT, h, hd)),
                 "ek": _normal(rng, (B, T_ENC, h, hd)),
                 "ev": _normal(rng, (B, T_ENC, h, hd)),
                 "g": _normal(rng, (B, S_ATT, h * hd))}
    params = TM.init_mamba2(torch.Generator().manual_seed(1), mcfg, 2)
    params.update(A_log=_normal(rng, (nh,), 0.5),
                  dt_bias=_normal(rng, (nh,), 0.5),
                  D=_normal(rng, (nh,)), conv_b=_normal(rng, (ch,), 0.1))
    ssm = {"xbc": _normal(rng, (B, S_SSM, ch)),
           "conv_w": params["conv_w"], "conv_b": params["conv_b"],
           "xin": _normal(rng, (B, S_SSM, d_in)),
           "dt": _normal(rng, (B, S_SSM, nh)),
           "B": _normal(rng, (B, S_SSM, n)), "C": _normal(rng, (B, S_SSM, n)),
           "A_log": params["A_log"], "dt_bias": params["dt_bias"],
           "D": params["D"], "x": _normal(rng, (B, S_SSM, mcfg.d_model)),
           "params": params, "g_conv": _normal(rng, (B, S_SSM, ch)),
           "g_scan": _normal(rng, (B, S_SSM, d_in)),
           "g_state": _normal(rng, (B, nh, n, hp)),
           "g_layer": _normal(rng, (B, S_SSM, mcfg.d_model))}
    return attention, ssm


def _j(t):
    return jnp.asarray(t.detach().numpy())


def _close(got, want, tol):
    want = torch.as_tensor(np.asarray(want))
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, tol * scale)


def _model_cases():
    """A train case and a decode case per model, with the one-device
    results they are held to."""
    cases, want = [], []
    for arch, (s, kw) in MODELS.items():
        cfg = _cfg(arch, **kw)
        params = {n: p.detach().clone() for n, p in TT.init_model(
            cfg, torch.Generator().manual_seed(0)).named_parameters()}
        rng = np.random.default_rng(1)
        batches = []
        for _ in range(2):
            toks = torch.tensor(rng.integers(0, cfg.vocab, (B, s + 1)),
                                dtype=torch.int32)
            b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            if cfg.family == "audio":
                b["frames"] = _normal(rng, (B, cfg.enc_frames, cfg.d_model))
            batches.append(b)
        model = TT.model_from(cfg, {k: v.clone() for k, v in params.items()})
        opt = TA.init(dict(model.named_parameters()))
        step = TST.make_train_step(cfg, TA.AdamWConfig(**OPT))
        steps = []
        for b in batches:
            model, opt, m = step(model, opt, b)
            steps.append((float(m["loss"]), float(m["grad_norm"])))
        cases.append(dict(kind="train", arch=arch, params=params,
                          batches=batches, opt=OPT, cfg=kw))
        want.append(steps)
        prompt = {k: v for k, v in batches[0].items() if k != "labels"}
        model = TT.model_from(cfg, {k: v.clone() for k, v in params.items()})
        with torch.no_grad():
            out, state = TT.forward_prefill(model, cfg, prompt, s + 4)
            logits = [out]
            for _ in range(2):
                tok = logits[-1].argmax(-1, keepdim=True).to(torch.int32)
                out, state = TT.forward_decode(model, cfg, state, tok)
                logits.append(out)
        cases.append(dict(kind="decode", arch=arch, params=params,
                          batch=prompt, cache_len=s + 4, steps=2, cfg=kw))
        want.append(logits)
    return cases, want


def _served_case():
    """The Server case and the one-device Server's tokens and logits."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.serve.server import Request, Server

    cfg = _cfg(SERVED["arch"], **SERVED["cfg"])
    params = {n: p.detach().clone() for n, p in TT.init_model(
        cfg, torch.Generator().manual_seed(3)).named_parameters()}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, S_ATT).astype(np.int32)
               for _ in range(SERVED["slots"])]
    srv = Server(cfg, TT.model_from(cfg, {k: v.clone() for k, v in
                                          params.items()}),
                 device="cpu", batch_slots=SERVED["slots"],
                 cache_len=SERVED["cache_len"])
    for uid, p in enumerate(prompts):
        srv.submit(Request(uid=uid, prompt=p, max_new_tokens=SERVED["new"]))
    logits = []
    done = srv.run(sample=lambda lg: (logits.append(lg.clone()),
                                      lg.argmax(-1))[1])
    assert SH.spec_for((cfg.n_heads,), ("heads",), {"model": MODEL}) \
        == SH.P("model")
    case = dict(kind="server", params=params, prompts=prompts,
                rules=dict(SH.DEFAULT_RULES, **SEQ_RULES), **SERVED)
    return case, {"tokens": [r.out_tokens for r in done], "logits": logits}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    attention, ssm = _inputs()
    models, want = _model_cases()
    served, served_want = _served_case()
    cases = [dict(kind="seq_pieces", attention=attention, ssm=ssm,
                  attn_chunk=ATT_CHUNK),
             dict(kind="seq_flops", attention=attention, ssm=ssm), *models,
             served]
    want.append(served_want)
    got = spawn_mesh_ranks(tmp_path_factory.mktemp("seq"), MODEL, MODEL,
                           cases)
    return {"inputs": (attention, ssm), "got": got, "want": want}


def _one_device_grads(fn, inputs: dict, cotangents) -> dict:
    leaves = {k: v.clone().requires_grad_(True) for k, v in inputs.items()}
    outs = fn(**leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, list(leaves.values()), cotangents)
    return dict(zip(leaves, grads))


def _seq_placed(piece):
    assert "Shard(dim=1)" in piece["placements"][0], piece["placements"]


def _hold_grads(piece, fn, inputs, cotangents):
    want = _one_device_grads(fn, inputs, cotangents)
    for name, g in want.items():
        _close(piece["grads"][name], g.numpy(), GRAD_TOL)


@pytest.mark.parametrize("piece", ["causal", "chunked", "full"])
def test_attention_on_query_rows_matches_reference(ranks, piece):
    att, _ = ranks["inputs"]
    acfg, rcfg = _cfg("whisper-tiny"), _rcfg("whisper-tiny")
    k, v = (att["k"], att["v"]) if piece != "full" else (att["ek"],
                                                         att["ev"])
    if piece == "full":
        mask = jnp.ones((B, S_ATT, T_ENC), bool)
        want = RATT._sdpa(_j(att["q"]), _j(k), _j(v), mask, rcfg)
    elif piece == "chunked":
        want = RATT._sdpa_chunked(_j(att["q"]), _j(k), _j(v), rcfg, ATT_CHUNK)
    else:
        mask = RATT.causal_mask(S_ATT)[None].repeat(B, axis=0)
        want = RATT._sdpa(_j(att["q"]), _j(k), _j(v), mask, rcfg)
    for rank in ranks["got"]:
        got = rank[0][piece]
        _close(got["out"][0], want, STEP_TOL)
        _seq_placed(got)
    if piece == "full":
        fn = lambda q, k, v: TATT._full_attention(q, k, v, acfg)  # noqa: E731
    else:
        cfg = dataclasses.replace(acfg, attn_chunk=ATT_CHUNK) \
            if piece == "chunked" else acfg
        fn = lambda q, k, v: TATT._self_attention(q, k, v, cfg)  # noqa: E731
    _hold_grads(ranks["got"][0][0][piece], fn,
                {"q": att["q"], "k": k, "v": v}, [att["g"]])


def test_conv_with_halo_matches_reference(ranks):
    _, ssm = ranks["inputs"]
    want = RM._causal_conv_train(_j(ssm["xbc"]), _j(ssm["conv_w"]),
                                 _j(ssm["conv_b"]))
    got = ranks["got"][0][0]["conv"]
    _close(got["out"][0], want, STEP_TOL)
    _seq_placed(got)
    _hold_grads(got, lambda xbc, conv_w, conv_b: TM._causal_conv_train(
        xbc, conv_w, conv_b),
                {k: ssm[k] for k in ("xbc", "conv_w", "conv_b")},
                [ssm["g_conv"]])


def test_scan_by_chunks_matches_reference(ranks):
    _, ssm = ranks["inputs"]
    cfg = _cfg("mamba2-130m")
    _, nh, _, hp = TM.dims(cfg)
    A = -jnp.exp(_j(ssm["A_log"]))
    dt = jax.nn.softplus(_j(ssm["dt"]) + _j(ssm["dt_bias"]))
    x = _j(ssm["xin"]).reshape(B, S_SSM, nh, hp)
    y, final = RM.ssd_chunked(x, dt, A, _j(ssm["B"]), _j(ssm["C"]),
                              cfg.ssm_chunk)
    y = (y + _j(ssm["D"])[None, None, :, None] * x).reshape(B, S_SSM, -1)
    got = ranks["got"][0][0]["scan"]
    _close(got["out"][0], y, SCAN_TOL)
    _close(got["out"][1], final, SCAN_TOL)
    _seq_placed(got)
    names = ("xin", "dt", "B", "C", "A_log", "dt_bias", "D")
    _hold_grads(got, lambda **a: TM._scan(*(a[k] for k in names), hp,
                                          cfg.ssm_chunk),
                {k: ssm[k] for k in names}, [ssm["g_scan"], ssm["g_state"]])


def test_mamba2_layer_and_cache_match_reference(ranks):
    _, ssm = ranks["inputs"]
    cfg, rcfg = _cfg("mamba2-130m"), _rcfg("mamba2-130m")
    p = {k: _j(v) for k, v in ssm["params"].items()}
    want, cache = RM.mamba2_forward(_j(ssm["x"]), p, rcfg, return_cache=True)
    got = ranks["got"][0][0]
    _close(got["layer"]["out"][0], want, SCAN_TOL)
    _seq_placed(got["layer"])
    _close(got["cache"]["conv"], cache.conv, STEP_TOL)
    _close(got["cache"]["state"], cache.state, SCAN_TOL)
    _hold_grads(got["layer"],
                lambda x, **q: TM.mamba2_forward(x, q, cfg),
                {"x": ssm["x"], **ssm["params"]}, [ssm["g_layer"]])


def test_each_device_does_a_third_of_the_work(ranks):
    _, ssm = ranks["inputs"]
    cfg = _cfg("mamba2-130m")
    _, nh, n, hp = TM.dims(cfg)
    summaries = MODEL * B * nh * n * hp * 4
    for rank in ranks["got"]:
        flops = rank[1]
        for name in ("layer", "attention"):
            assert flops[name]["mesh"] <= SPLIT_SHARE * flops[name]["one"], (
                name, flops[name])
        assert 0 < flops["layer"]["gathered"] <= summaries, flops["layer"]


@pytest.mark.parametrize("arch", list(MODELS))
def test_meshed_models_match_one_device(ranks, arch):
    i = 2 + 2 * list(MODELS).index(arch)
    steps, logits = ranks["want"][i - 2], ranks["want"][i - 1]
    for rank in ranks["got"]:
        train, served = rank[i], rank[i + 1]
        for (loss, norm), got_loss, got_norm in zip(
                steps, train["loss"], train["grad_norm"]):
            assert abs(got_loss - loss) <= MESH_LOSS_REL * abs(loss)
            assert abs(got_norm - norm) <= MESH_GNORM_REL * abs(norm)
        for got, want in zip(served["logits"], logits):
            _close(got, want.numpy(), MESH_LOGIT_REL)


def test_server_under_heads_unsplit_rules_matches_one_device(ranks):
    want = ranks["want"][-1]
    for rank in ranks["got"]:
        got = rank[-1]
        assert got["tokens"] == want["tokens"]
        assert got["params_laid_out"]
        assert len(got["logits"]) == len(want["logits"])
        for g, w in zip(got["logits"], want["logits"]):
            _close(g, w.numpy(), MESH_LOGIT_REL)


def test_flash_route_refuses_offset_rows(monkeypatch):
    cfg = _cfg("granite-3-2b")
    rng = np.random.default_rng(2)
    q, k, v = (_normal(rng, (1, 256, 4, 64)) for _ in range(3))
    assert TATT._flash_route(q, k, cfg)
    assert not TATT._flash_route(q[:, 128:], k, cfg)
    calls = []
    flash = TATT.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return flash(*a, **kw)

    monkeypatch.setattr(TATT, "flash_attention", counted)
    whole = TATT._self_attention(q, k, v, cfg)
    assert len(calls) == 1
    rows = TATT._self_attention(q[:, 128:], k, v, cfg, offset=128)
    assert len(calls) == 1
    mask = TATT.causal_mask(128, offset=128)[None]
    _close(rows, TATT._sdpa(q[:, 128:], k, v, mask, cfg).numpy(), STEP_TOL)
    _close(rows, whole[:, 128:].detach().numpy(), STEP_TOL)


def test_ssd_gradient_is_finite_where_a_chunk_overflows_exp():
    """Above a chunk's diagonal the decay exponent is a sum of -dt·A,
    which overflows exp in a long chunk (full-width mamba2-130m, chunk
    256, random weights: about +500); masked after the exp, its
    gradient was 0 · inf = NaN, so every training step's grad_norm was
    NaN.  The forward is the reference's, and the gradient that of the
    same scan at a chunk short enough not to overflow."""
    rng = np.random.default_rng(5)
    b, s, h, p, n = 1, 64, 2, 4, 3
    x, B_, C_ = (_normal(rng, shape) for shape in
                 ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.tensor(rng.uniform(2.0, 5.0, (b, s, h)).astype(np.float32))
    A = torch.full((h,), -2.7)
    want, _ = RM.ssd_chunked(_j(x), _j(dt), _j(A), _j(B_), _j(C_), s)
    grads = {}
    for chunk in (s, 8):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt)]
        y, final = TM.ssd_chunked(leaves[0], leaves[1], A, B_, C_, chunk)
        if chunk == s:
            _close(y.detach(), want, STEP_TOL)
        grads[chunk] = torch.autograd.grad(y.sum() + final.sum(), leaves)
    for got, short in zip(grads[s], grads[8]):
        assert bool(torch.isfinite(got).all())
        _close(got, short.numpy(), SCAN_TOL)
