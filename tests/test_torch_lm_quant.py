"""The port's C3 codebook-quantized LM serving against the JAX package, on
the CPU.

Fixtures at f32: the reference's own quantized-serving fixture
(tests/test_models.py `tiny("dense", n_kv_heads=4, d_model=128,
d_ff=512)`: the MLP stacks quantize) and a moe fixture whose expert
stacks quantize (d 128, ff 128, 4 experts: 2 x 4 x 128 x 128 >= 2^16),
each with `init_model(PRNGKey(0))`.  The reference's quantized blocks
(int8 and 4-bit) are carried across by `convert_lm` and served through
prefill and decode, so the serving path is held apart from the k-means
fit; the port's own `quantize_blocks` is held to the reference's fit
(equal indexes, codebooks within 4 ulp).  The 2-D quantized products go
through `models.common.linear` and `ops.codebook_matmul` (its plain
version here), counted per layer.
"""
import dataclasses
import functools
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import convert_lm
from repro_torch.core.quant import CodebookConfig
from repro_torch.kernels import ops
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.quant import lm_quant as TQ
from repro_torch.serve import server as TS

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.models import common as RC  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.quant import lm_quant as RQ  # noqa: E402

LOGIT_TOL = 1e-4     # as tests/test_torch_lm.py
FIT_ULP = 4          # codebooks of one fit: centroids a few ulp apart
REPORT_REL = 1e-6    # relative RMS errors of two fits a few ulp apart
SERVE_GAP = 1e-3     # fixture check: no top-2 logit gap below this

FIXTURES = {
    "dense": ("dense", dict(n_kv_heads=4, d_model=128, d_ff=512)),
    "moe": ("moe", dict(n_kv_heads=4, d_model=128, d_ff=128, n_experts=4,
                        top_k=2, moe_group_size=32)),
}


def _cfgs(family, **kw):
    """tests/test_models.py `tiny`, as the reference's and the port's
    ArchConfig."""
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=97)
    base.update(kw)
    return (RC.ArchConfig(f"{family}-q", family, dtype=jnp.float32, **base),
            TC.ArchConfig(f"{family}-q", family, dtype=torch.float32,
                          **base))


@functools.cache
def _setup(fixture: str):
    """(rcfg, tcfg, params, port float model, reference blocks int8,
    reference blocks 4-bit)."""
    rcfg, tcfg = _cfgs(*FIXTURES[fixture][:1], **FIXTURES[fixture][1])
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(0))
    model = convert_lm(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return (rcfg, tcfg, params, model, RQ.quantize_blocks(params["blocks"]),
            RQ.quantize_blocks(params["blocks"], pack_4bit=True))


@functools.cache
def _port_fit(fixture: str, pack: bool):
    return TQ.quantize_blocks(_setup(fixture)[3], pack_4bit=pack)


def _ref_quantized(fixture: str, pack: bool):
    rcfg, tcfg, params, _, qb8, qb4 = _setup(fixture)
    qp = dict(params, blocks=qb4 if pack else qb8)
    return rcfg, tcfg, qp, convert_lm(jax.tree.map(np.asarray, qp), tcfg,
                                      device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _ulp_diff(got, want) -> float:
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.max(np.abs(g - w) / np.spacing(np.maximum(np.abs(w),
                                                               1e-30))))


CASES = [("dense", False), ("dense", True), ("moe", False), ("moe", True)]
CASE_IDS = ["dense-int8", "dense-4bit", "moe-int8", "moe-4bit"]


# ---------------------------------------------------------------------------
# which leaves quantize, the fit, the byte count and the report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "granite-3-2b",
                                  "moonshot-v1-16b-a3b", "dense", "moe"])
def test_quantizable_reads_the_stacked_size(name):
    """The port holds one layer: its rule on a layer's leaf gives the
    reference's on the stacked (L, ...) leaf.  At granite-moe-1b-a400m's
    full width the router (24 x 1024 x 32) and every attention weight
    quantize, though one layer's router is 32,768 weights."""
    from repro_torch.configs import registry as TR

    if name in FIXTURES:
        tcfg = _cfgs(*FIXTURES[name][:1], **FIXTURES[name][1])[1]
    else:
        tcfg = TR.get_arch(name)
    L = tcfg.n_layers
    got, want = {}, {}
    for leaf, shape in TT._layer_shapes(tcfg).items():
        for dt, rdt in ((torch.bfloat16, jnp.bfloat16),
                        (torch.float32, jnp.float32)):
            got[leaf, dt] = TQ._quantizable(
                leaf, torch.empty(shape, dtype=dt, device="meta"), L)
            want[leaf, dt] = RQ._quantizable(
                leaf, jax.ShapeDtypeStruct((L,) + shape, rdt))
        assert not TQ._quantizable(
            leaf, torch.empty(shape, dtype=torch.int8, device="meta"), L)
    assert got == want
    if name == "granite-moe-1b-a400m":
        assert all(got[k, torch.bfloat16] for k in
                   ("router", "wq", "wk", "wv", "wo", "moe_wi"))


@pytest.mark.parametrize("fixture,pack", CASES, ids=CASE_IDS)
def test_quantize_blocks_matches_reference(fixture, pack):
    """The port's fit of the carried float model against the reference's:
    the same leaves quantized, indexes equal, codebooks within 4 ulp;
    the other leaves and the embeddings passed through unchanged."""
    _, tcfg, _, model, qb8, qb4 = _setup(fixture)
    ref = qb4 if pack else qb8
    qmodel = _port_fit(fixture, pack)
    key = "idx4" if pack else "idx"
    assert qmodel.embed is not model.embed
    assert torch.equal(qmodel.embed, model.embed)
    quantized = {n for n, v in ref.items() if isinstance(v, dict)}
    assert quantized and quantized == {
        n for n, v in qmodel.blocks[0].leaves().items()
        if isinstance(v, dict)}
    for i, block in enumerate(qmodel.blocks):
        leaves = block.leaves()
        for name, v in ref.items():
            if name in quantized:
                assert set(leaves[name]) == {key, "cb"}
                got = leaves[name][key]
                assert got.dtype == (torch.uint8 if pack else torch.int8)
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(v[key][i]))
                assert leaves[name]["cb"].dtype == torch.float32
                assert _ulp_diff(leaves[name]["cb"].numpy(),
                                 v["cb"][i]) <= FIT_ULP, name
            else:
                assert torch.equal(leaves[name], model.blocks[i][name])


@pytest.mark.parametrize("fixture,pack", CASES, ids=CASE_IDS)
def test_quantized_bytes_match_reference(fixture, pack):
    _, _, _, model, qb8, qb4 = _setup(fixture)
    qmodel = _port_fit(fixture, pack)
    assert TQ.quantized_bytes(qmodel) == RQ.quantized_bytes(
        qb4 if pack else qb8)
    _, _, _, carried = _ref_quantized(fixture, pack)
    assert TQ.quantized_bytes(carried) == RQ.quantized_bytes(
        qb4 if pack else qb8)
    before, after = TQ.quantized_bytes(model)
    assert before == after                       # nothing quantized


@pytest.mark.parametrize("fixture,pack", CASES, ids=CASE_IDS)
def test_quantization_report_matches_reference(fixture, pack):
    _, _, params, model, qb8, qb4 = _setup(fixture)
    want = RQ.quantization_report(params["blocks"], qb4 if pack else qb8)
    got = TQ.quantization_report(model, _port_fit(fixture, pack))
    assert set(got) == set(want) and want
    for name, r in want.items():
        assert type(got[name]) is float
        assert abs(got[name] - r) <= REPORT_REL * abs(r), name


def test_quantize_blocks_4bit_needs_an_even_last_dim():
    _, tcfg = _cfgs("dense", d_model=128, d_ff=257)
    model = TT.init_model(tcfg, torch.Generator().manual_seed(0))
    cheap = CodebookConfig(16, 8, kmeans_iters=1)
    with pytest.raises(ValueError, match="even last dim"):
        TQ.quantize_blocks(model, cheap, pack_4bit=True)
    q = TQ.quantize_blocks(model, cheap)              # int8 takes it
    assert q.blocks[0].leaves()["mlp_wi"]["idx"].shape == (128, 257)


@pytest.mark.parametrize("pack", [False, True], ids=["int8", "4bit"])
def test_convert_lm_carries_quantized_blocks_bit_for_bit(pack):
    _, tcfg, qp, qmodel = _ref_quantized("moe", pack)
    key = "idx4" if pack else "idx"
    seen = 0
    for name, v in qp["blocks"].items():
        for i, block in enumerate(qmodel.blocks):
            got = block.leaves()[name]
            if isinstance(v, dict):
                seen += 1
                for k in (key, "cb"):
                    want = np.asarray(v[k][i])
                    assert got[k].numpy().dtype == want.dtype
                    np.testing.assert_array_equal(got[k].numpy(), want)
            else:
                np.testing.assert_array_equal(got.detach().numpy(),
                                              np.asarray(v[i]))
    assert seen == 3 * tcfg.n_layers          # moe_wi, moe_wg, moe_wo
    names = dict(qmodel.named_buffers())
    assert f"blocks.1.moe_wo.{key}" in names and "blocks.0.moe_wi.cb" in names


# ---------------------------------------------------------------------------
# the transform and the projection hook
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", ["dense", "moe"])
def test_param_transform_operands_hold_the_reference_weights(fixture):
    """bf16 serving: a 2-D leaf becomes a CodebookWeight whose cb[idx] is
    bitwise the reference's `cb[idx].astype(bf16)`; an expert stack the
    dense bf16 weights themselves."""
    _, _, qp, qmodel = _ref_quantized(fixture, True)
    lp = jax.tree.map(lambda a: a[1], qp["blocks"])
    want = RQ.make_param_transform(jnp.bfloat16)(lp)
    got = TQ.make_param_transform(torch.bfloat16)(qmodel.blocks[1].leaves())
    kinds = set()
    for name, v in lp.items():
        if not isinstance(v, dict):
            assert got[name] is qmodel.blocks[1][name]
            continue
        w = np.asarray(want[name].astype(jnp.float32))
        g = got[name]
        if isinstance(g, TC.CodebookWeight):
            kinds.add("2-D")
            assert g.idx.dtype == torch.int8 and g.idx.is_contiguous()
            assert g.cb.dtype == torch.float32
            assert torch.equal(g.cb, g.cb.to(torch.bfloat16).float())
            np.testing.assert_array_equal(g.cb[g.idx.long()].numpy(), w)
        else:
            kinds.add("dense")
            assert g.dtype == torch.bfloat16 and g.dim() == 3
            np.testing.assert_array_equal(g.float().numpy(), w)
    assert kinds == ({"2-D"} if fixture == "dense" else {"dense"})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_linear_on_a_codebook_weight(dtype):
    """(B, S, K) x, a transposed view, through the plain codebook product:
    x's type out, the f32 product rounded once."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(0, 1, (2, 40, 24)).astype(np.float32)
                     ).to(dtype).transpose(1, 2)              # (2, 24, 40)
    idx = torch.tensor(rng.integers(0, 16, (40, 12)).astype(np.int8))
    cb = torch.tensor(np.sort(rng.normal(0, 0.2, 16)).astype(np.float32))
    w = TC.CodebookWeight(idx, cb)
    got = TC.linear(x, w)
    assert got.dtype == dtype and got.shape == (2, 24, 12)
    want = (x.float().reshape(-1, 40) @ cb[idx.long()]).to(dtype)
    assert torch.equal(got.reshape(-1, 12), want)
    dense = cb[idx.long()].to(dtype)
    assert torch.equal(TC.linear(x, dense), x @ dense)


# fixtures in which every 2-D projection quantizes: d 256 makes each
# attention weight >= 2^16 over 2 layers, and 128 experts the router
_ALL_2D = {"dense": ("dense", dict(d_model=256, n_heads=4, n_kv_heads=2,
                                   d_ff=256), 7),
           "moe": ("moe", dict(d_model=256, n_heads=4, n_kv_heads=2, d_ff=16,
                               n_experts=128, top_k=2, moe_group_size=32),
                   5)}


@pytest.mark.parametrize("fixture", ["dense", "moe"])
def test_quantized_forward_calls_codebook_matmul_per_projection(
        fixture, monkeypatch):
    """One prefill and one decode step: `ops.codebook_matmul` once per 2-D
    projection and layer (wq, wk, wv, wo + mlp_wi, mlp_wg, mlp_wo, or +
    router), on contiguous (M, K) operands."""
    family, kw, per_layer = _ALL_2D[fixture]
    _, tcfg = _cfgs(family, **kw)
    model = TT.init_model(tcfg, torch.Generator().manual_seed(0))
    qmodel = TQ.quantize_blocks(model, CodebookConfig(16, 8, kmeans_iters=2))
    n_2d = sum(isinstance(v, dict) and v["idx"].dim() == 2
               for v in qmodel.blocks[0].leaves().values())
    assert n_2d == per_layer
    calls = []
    plain = ops.codebook_matmul

    def spy(x, idx, cb):
        assert x.dim() == 2 and x.is_contiguous()
        calls.append(tuple(idx.shape))
        return plain(x, idx, cb)

    monkeypatch.setattr(ops, "codebook_matmul", spy)
    pt = TQ.make_param_transform(torch.float32)
    toks = torch.tensor(_tokens(4, 2, 12, tcfg.vocab))
    _, st = TT.forward_prefill(qmodel, tcfg, {"tokens": toks}, 16,
                               param_transform=pt)
    assert len(calls) == per_layer * tcfg.n_layers
    calls.clear()
    logits, _ = TT.forward_decode(qmodel, tcfg, st, toks[:, :1],
                                  param_transform=pt)
    assert len(calls) == per_layer * tcfg.n_layers
    assert bool(logits.isfinite().all())


# ---------------------------------------------------------------------------
# serving the reference's quantized weights
# ---------------------------------------------------------------------------

SERVE_CASES = [("dense", False, None), ("dense", True, None),
               ("dense", False, "int8"), ("moe", False, None),
               ("moe", True, None), ("moe", False, "int8")]
SERVE_IDS = ["dense-int8", "dense-4bit", "dense-int8-kv8", "moe-int8",
             "moe-4bit", "moe-int8-kv8"]


def _with_kv(rcfg, tcfg, kv):
    if kv is None:
        return rcfg, tcfg
    return (dataclasses.replace(rcfg, kv_cache_dtype=jnp.int8),
            dataclasses.replace(tcfg, kv_cache_dtype=torch.int8))


@pytest.mark.parametrize("fixture,pack", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("s", [256, 16], ids=["S256-flash", "S16-plain"])
def test_quantized_prefill_matches_reference(fixture, pack, s):
    rcfg, tcfg, qp, qmodel = _ref_quantized(fixture, pack)
    toks = _tokens(s + 1, 2, s, tcfg.vocab)
    want, rst = RT.forward_prefill(
        qp, rcfg, {"tokens": jnp.asarray(toks)}, s + 8,
        param_transform=RQ.make_param_transform(jnp.float32))
    got, st = TT.forward_prefill(
        qmodel, tcfg, {"tokens": torch.tensor(toks)}, s + 8,
        param_transform=TQ.make_param_transform(torch.float32))
    _close(got, want, LOGIT_TOL)
    _close(st.kv.k, rst.kv.k, LOGIT_TOL)
    _close(st.kv.v, rst.kv.v, LOGIT_TOL)


@pytest.mark.parametrize("fixture,pack,kv", SERVE_CASES, ids=SERVE_IDS)
def test_quantized_decode_steps_match_reference(fixture, pack, kv):
    """Four decode steps after a 16-token prefill; with the int8 KV cache
    from empty int8 caches (`init_decode_state`), since a prefill's
    caches are of the model's type in both packages."""
    rcfg, tcfg, qp, qmodel = _ref_quantized(fixture, pack)
    rcfg, tcfg = _with_kv(rcfg, tcfg, kv)
    rpt = RQ.make_param_transform(jnp.float32)
    tpt = TQ.make_param_transform(torch.float32)
    toks = _tokens(13, 2, 20, tcfg.vocab)
    if kv:
        rst = RT.init_decode_state(rcfg, 2, 24)
        st = TT.init_decode_state(tcfg, 2, 24, device="cpu")
        assert st.kv.k.dtype == torch.int8
    else:
        _, rst = RT.forward_prefill(qp, rcfg,
                                    {"tokens": jnp.asarray(toks[:, :16])},
                                    24, param_transform=rpt)
        _, st = TT.forward_prefill(qmodel, tcfg,
                                   {"tokens": torch.tensor(toks[:, :16])},
                                   24, param_transform=tpt)
    start = int(st.pos)
    for i in range(16, 20):
        want, rst = RT.forward_decode(qp, rcfg, rst,
                                      jnp.asarray(toks[:, i:i + 1]),
                                      param_transform=rpt)
        got, st = TT.forward_decode(qmodel, tcfg, st,
                                    torch.tensor(toks[:, i:i + 1]),
                                    param_transform=tpt)
        _close(got, want, LOGIT_TOL)
        assert int(st.pos) == int(rst.pos) == start + i - 15


@pytest.mark.parametrize("fixture,pack", [("dense", True), ("moe", False)],
                         ids=["dense-4bit", "moe-int8"])
def test_quant_server_tokens_equal_reference(fixture, pack):
    from repro.launch.mesh import make_host_mesh
    from repro.serve.server import Request as RRequest
    from repro.serve.server import Server as RServer

    rcfg, tcfg, qp, qmodel = _ref_quantized(fixture, pack)
    q = "4bit" if pack else True
    rcfg = dataclasses.replace(rcfg, quant_serving=q)
    tcfg = dataclasses.replace(tcfg, quant_serving=q)
    prompts = [np.random.default_rng(40 + i).integers(0, tcfg.vocab, 24)
               .astype(np.int32) for i in range(3)]
    gaps = []

    def greedy(lg):
        top2 = np.sort(np.asarray(lg), axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        return jnp.argmax(lg, axis=-1)

    rsrv = RServer(rcfg, qp, make_host_mesh(), batch_slots=2, cache_len=32)
    tsrv = TS.Server(tcfg, qmodel, device="cpu", batch_slots=2, cache_len=32)
    for i, pr in enumerate(prompts):
        rsrv.submit(RRequest(uid=i, prompt=pr, max_new_tokens=4))
        tsrv.submit(TS.Request(uid=i, prompt=pr, max_new_tokens=4))
    want = rsrv.run(sample=greedy)
    assert min(gaps) > SERVE_GAP          # the fixture has no near-tie
    got = tsrv.run()
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


def test_launch_serve_quant_prints_the_reference_bytes(capsys, monkeypatch):
    from repro.launch import serve as rserve
    from repro_torch.launch import serve

    args = ["--arch", "granite-moe-1b-a400m", "--smoke", "--requests", "2",
            "--prompt-len", "12", "--max-new", "2", "--slots", "2",
            "--quant"]
    done = serve.main(args + ["--device", "cpu"])
    assert len(done) == 2 and all(len(r.out_tokens) == 2 for r in done)
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    rserve.main()
    want = capsys.readouterr().out.splitlines()
    line = [ln for ln in want if ln.startswith("C3 quantized serving")]
    assert len(line) == 1 and line[0] in got
    assert "served 2 requests / 4 tokens" in got[-1]
