"""LM serving on a DeviceMesh against the JAX package, on the CPU.

gloo ranks spawned once for the module (tests/torch_mesh_ranks.py) mesh
themselves at world 2 and serve through `Server(mesh=...)`: each
family's SMOKE config in f32 (dense, moe, ssm, hybrid, audio, vlm) on
data 1 x model 2, the dense fixture of tests/test_torch_lm_quant.py
with C3 int8 and 4-bit indexes (its MLP stacks quantize) and the moe
one with C3 int8 expert stacks, and dense and moe on data 2 x model 1
(the moe decode groups straddle the two batch shards), from the
reference's weights carried across by `convert_lm`.  Held:

* every step's logits within LOGIT_REL of their largest magnitude of
  the port's one-device `Server` on the same weights and prompts;
* the tokens equal to the JAX `repro.serve.server.Server`'s on a
  one-device `make_host_mesh()`, on fixtures whose top-2 logit gaps all
  exceed SERVE_GAP, and equal on every rank;
* the parameters and C3 buffers laid out by `serving_param_specs`
  (which is `serve_shardings`' rule), the prefill's caches by
  `decode_state_specs`.

The moe layer of a decode step on data 2 x model 1 does half of the
one-device layer's expert FLOPs on each rank; a mamba2 decode step's
in_proj, out_proj and logits on data 1 x model 2 (its heads unsplit)
half of one device's each, and a zamba2 layer's prefill gathers no
in_proj output whole (its output and cache the one-device layer's).
mamba2 also decodes with its state split over N and a vocab "model"
does not divide, and serves C3 int8.  Also `make_prefill_step`
/ `make_decode_step` at `mesh=None` against
`forward_prefill` / `forward_decode`, and `launch.serve --model-parallel
2` on the CPU.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.convert import convert_lm
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as TST
from repro_torch.models import transformer as TT
from repro_torch.serve import server as TS

sys.path.insert(0, str(Path(__file__).parent))
from torch_mesh_ranks import spawn_mesh_ranks  # noqa: E402

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as RR  # noqa: E402
from repro.launch.mesh import make_host_mesh as r_host_mesh  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.quant import lm_quant as RQ  # noqa: E402
from repro.serve.server import Request as RRequest  # noqa: E402
from repro.serve.server import Server as RServer  # noqa: E402

LOGIT_REL = 1e-5          # of the logits' largest magnitude
SERVE_GAP = 1e-3          # fixture check: no top-2 logit gap below this
SLOTS, CACHE, NEW = 2, 32, 4
# tests/test_torch_lm_quant.py's fixtures, whose stacks quantize
C3_DENSE = dict(n_kv_heads=4, d_model=128, d_ff=512)
C3_MOE = dict(n_kv_heads=4, d_model=128, d_ff=128, n_experts=4, top_k=2,
              moe_group_size=32)
# the moe fixture quantizes its router and attention too (2-D products
# on the kernel beside the gathered expert stacks): the reference's
# size rule lowered for its fit
QUANT_MIN = {"moe-c3-int8": 1 << 10, "ssm-c3-int8": 1 << 10}
# case -> (arch, config fields, quant_serving, model-axis size)
CASES = {
    "dense": ("granite-3-2b", {}, False, 2),
    "moe": ("granite-moe-1b-a400m", {}, False, 2),
    "ssm": ("mamba2-130m", {}, False, 2),
    "hybrid": ("zamba2-2.7b", {}, False, 2),
    "audio": ("whisper-tiny", {}, False, 2),
    "vlm": ("phi-3-vision-4.2b", {}, False, 2),
    "dense-c3-int8": ("granite-3-2b", C3_DENSE, True, 2),
    "dense-c3-4bit": ("granite-3-2b", C3_DENSE, "4bit", 2),
    "moe-c3-int8": ("granite-moe-1b-a400m", C3_MOE, True, 2),
    "dense-2x1": ("granite-3-2b", {}, False, 1),
    "moe-2x1": ("granite-moe-1b-a400m", {}, False, 1),
    "ssm-c3-int8": ("mamba2-130m", {}, True, 2),
}


def _cfgs(case):
    arch, kw, quant, _ = CASES[case]
    return (dataclasses.replace(RR.get_arch(arch, smoke=True),
                                dtype=jnp.float32, quant_serving=quant, **kw),
            dataclasses.replace(TR.get_arch(arch, smoke=True),
                                dtype=torch.float32, quant_serving=quant,
                                **kw))


@functools.cache
def _setup(case):
    """(reference config, port config, reference params, port model):
    the reference's init, its blocks quantized (4-bit packed for
    "4bit") when the case serves C3, carried across by `convert_lm`."""
    rcfg, tcfg = _cfgs(case)
    params, _ = RT.init_model(rcfg, jax.random.PRNGKey(0))
    if rcfg.quant_serving:
        size = RQ._QUANT_MIN_SIZE
        RQ._QUANT_MIN_SIZE = QUANT_MIN.get(case, size)
        try:
            params = dict(params, blocks=RQ.quantize_blocks(
                params["blocks"], pack_4bit=rcfg.quant_serving == "4bit"))
        finally:
            RQ._QUANT_MIN_SIZE = size
    model = convert_lm(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return rcfg, tcfg, params, model


def _leaves(model) -> dict:
    """{parameter name: tensor}, and a C3 leaf's {"idx" | "idx4", "cb"}
    under its weight's name (what `model_from` takes)."""
    out = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, block in enumerate(model.blocks):
        for name, v in block.leaves().items():
            if isinstance(v, dict):
                out[f"blocks.{i}.{name}"] = {k: t.clone()
                                             for k, t in v.items()}
    return out


def _prompts(case) -> list:
    """Three prompts of 12, 9 and 12 tokens (the first batch left-pads
    the 9; the second holds one request), seeded by the case's name."""
    vocab = _cfgs(case)[1].vocab
    seed = sum(map(ord, case))
    return [np.random.default_rng(seed + i).integers(0, vocab, n)
            .astype(np.int32) for i, n in enumerate((12, 9, 12))]


def _cache(case) -> int:
    return CACHE + _cfgs(case)[1].n_patches


# mamba2's decode products on data 1 x model 2: its 4 heads unsplit in
# the parameters (16 does not divide them), a vocab 2 does not divide
SSM_FLOPS_CFG = {"vocab": 255}
SSM_FLOPS_SLOTS = 4
# mamba2 with one SSD head: its decode state splits over N on "model"
# (the step `mamba2._ssm_step_on_state_shards`), the vocab unevenly
SSM_N_SPLIT_CFG = {"ssm_head_dim": 128, "vocab": 255}
# a zamba2 layer's prefill on data 1 x model 2: B x S = 128 rows, more
# than the in_proj rows its pieces gather (64 + 64 / 2), so in_proj runs
# one product per piece on the heads' columns
HYBRID_SHAPE = (2, 64)


def _ssm_cfg(kw: dict):
    return dataclasses.replace(TR.get_arch("mamba2-130m", smoke=True),
                               dtype=torch.float32, **kw)


def _ssm_params(kw: dict) -> dict:
    return _leaves(TT.init_model(_ssm_cfg(kw),
                                 torch.Generator().manual_seed(0)))


@functools.cache
def _n_split_case() -> dict:
    toks = np.random.default_rng(5).integers(0, SSM_N_SPLIT_CFG["vocab"],
                                             (SLOTS, 12))
    return dict(kind="decode", arch="mamba2-130m", cfg=SSM_N_SPLIT_CFG,
                params=_ssm_params(SSM_N_SPLIT_CFG),
                batch={"tokens": torch.tensor(toks, dtype=torch.int32)},
                cache_len=CACHE, steps=3)


@functools.cache
def _hybrid_case() -> dict:
    cfg = _cfgs("hybrid")[1]
    rng = np.random.default_rng(3)
    shape = (*HYBRID_SHAPE, cfg.d_model)
    return dict(kind="hybrid_layer", arch="zamba2-2.7b",
                params=_leaves(_setup("hybrid")[3]),
                x=torch.tensor(rng.standard_normal(shape),
                               dtype=torch.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case served on two gloo ranks spawned once, and the moe
    layer's FLOPs traced ("moe-flops"): {case: [rank 0's result, rank
    1's]}."""
    cases = [dict(kind="server", arch=CASES[c][0], params=_leaves(
        _setup(c)[3]), cfg=dict(CASES[c][1], quant_serving=CASES[c][2]),
        model=CASES[c][3], prompts=_prompts(c), slots=SLOTS,
        cache_len=_cache(c), new=NEW) for c in CASES]
    cases.append(dict(kind="moe_flops", arch=CASES["moe"][0],
                      params=_leaves(_setup("moe")[3]), slots=SLOTS))
    cases.append(dict(kind="ssm_decode_flops", arch="mamba2-130m",
                      cfg=SSM_FLOPS_CFG, params=_ssm_params(SSM_FLOPS_CFG),
                      slots=SSM_FLOPS_SLOTS))
    cases.append(_hybrid_case())
    cases.append(_n_split_case())
    out = spawn_mesh_ranks(tmp_path_factory.mktemp("serve"), 2, 2, cases)
    names = [*CASES, "moe-flops", "ssm-flops", "hybrid-layer",
             "ssm-n-split"]
    return {c: [r[i] for r in out] for i, c in enumerate(names)}


def _one_device(case) -> tuple:
    """The port's one-device Server: (tokens, every step's logits)."""
    _, tcfg, _, model = _setup(case)
    srv = TS.Server(tcfg, model, device="cpu", batch_slots=SLOTS,
                    cache_len=_cache(case))
    for i, p in enumerate(_prompts(case)):
        srv.submit(TS.Request(uid=i, prompt=p, max_new_tokens=NEW))
    logits = []
    done = srv.run(sample=lambda lg: (logits.append(lg), lg.argmax(-1))[1])
    return [r.out_tokens for r in done], logits


@functools.cache
def _reference_tokens(case) -> tuple:
    """The JAX Server's tokens on a one-device mesh, and the smallest
    top-2 logit gap it saw."""
    rcfg, _, params, _ = _setup(case)
    gaps = []

    def greedy(lg):
        top2 = np.sort(np.asarray(lg), axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        return jnp.argmax(lg, axis=-1)

    srv = RServer(rcfg, params, r_host_mesh(), batch_slots=SLOTS,
                  cache_len=_cache(case))
    for i, p in enumerate(_prompts(case)):
        srv.submit(RRequest(uid=i, prompt=p, max_new_tokens=NEW))
    done = srv.run(sample=greedy)
    return [r.out_tokens for r in done], min(gaps)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_server_matches_one_device_and_reference(ranks, case):
    got = ranks[case]
    want_tokens, want_logits = _one_device(case)
    ref_tokens, gap = _reference_tokens(case)
    assert gap > SERVE_GAP                 # the fixture has no near-tie
    for r in got:
        assert r["tokens"] == got[0]["tokens"] == ref_tokens == want_tokens
        assert all(len(t) == NEW for t in r["tokens"])
        assert len(r["logits"]) == len(want_logits) == 2 * NEW
        for g, w in zip(r["logits"], want_logits):
            assert g.shape == w.shape
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= LOGIT_REL * scale


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_server_lays_out_params_and_caches(ranks, case):
    for r in ranks[case]:
        assert r["params_laid_out"]
        assert r["state_specs"] == r["state_specs_want"]
    quantized = [b for b in ranks[case][0]["buffers"]]
    quant = CASES[case][2]
    assert bool(quantized) == bool(quant)
    if quant:
        key = "idx4" if quant == "4bit" else "idx"
        assert all(b.endswith((f".{key}", ".cb")) for b in quantized)


def test_meshed_moe_decode_halves_each_ranks_expert_flops(ranks):
    """A decode step's moe layer (SLOTS rows, one dispatch group over
    both batch shards) on data 2 x model 1: each rank keeps its half of
    the expert stacks' d (no stack gathered) and does half of the
    one-device layer's expert FLOPs (all but the router product, which
    each rank runs on every row); its output is the one-device layer's
    within LOGIT_REL."""
    _, tcfg, _, _ = _setup("moe")
    e, d, ff = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    for r in ranks["moe-flops"]:
        assert r["stacks"] == {"moe_wi": (e, d // 2, ff),
                               "moe_wg": (e, d // 2, ff),
                               "moe_wo": (e, ff, d // 2)}
        assert r["router"] == 2 * SLOTS * d * e
        assert r["one"] > r["router"]
        assert r["mesh"] - r["router"] == (r["one"] - r["router"]) / 2
        assert r["per_kind"]["all-gather"] < 4
        scale = float(r["want"].abs().max())
        assert float((r["got"] - r["want"]).abs().max()) <= LOGIT_REL * scale


@pytest.mark.parametrize("product", ["in_proj", "out_proj", "logits"])
def test_meshed_mamba2_decode_halves_each_ranks_products(ranks, product):
    """A mamba2 decode step's products on data 1 x model 2, the heads
    unsplit in the parameters: each rank runs in_proj on half of each
    piece's columns, out_proj on half of its rows (its input, z, split
    alike; a partial sum) and the logits on its slice of the 255-wide
    vocabulary (128 or 127 columns): half of one device's FLOPs, and the
    one-device outputs within LOGIT_REL."""
    vocab = SSM_FLOPS_CFG["vocab"]
    for rank, r in enumerate(ranks["ssm-flops"]):
        got = r[product]
        share = (vocab + 1 - 2 * rank) // 2 / vocab if product == "logits" \
            else 0.5
        assert got["one"] > 0 and got["mesh"] == got["one"] * share
        scale = float(got["want"].abs().max())
        assert float((got["got"] - got["want"]).abs().max()) <= \
            LOGIT_REL * scale


def test_meshed_mamba2_decode_of_a_state_split_over_n(ranks):
    """mamba2 with one SSD head on data 1 x model 2: its decode state is
    split over N on "model", each rank steps its slice (y summed in f32),
    and the logits split a 255-wide vocab unevenly; a prefill and three
    greedy decode steps are the one-device model's within LOGIT_REL."""
    case = _n_split_case()
    cfg = _ssm_cfg(SSM_N_SPLIT_CFG)
    model = TT.model_from(cfg, case["params"])
    out, state = TT.forward_prefill(model, cfg, case["batch"],
                                    case["cache_len"])
    want = [out]
    for _ in range(case["steps"]):
        tok = want[-1].argmax(-1, keepdim=True).to(torch.int32)
        out, state = TT.forward_decode(model, cfg, state, tok)
        want.append(out)
    for r in ranks["ssm-n-split"]:
        assert len(r["logits"]) == len(want)
        for g, w in zip(r["logits"], want):
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= LOGIT_REL * scale


def test_meshed_hybrid_prefill_gathers_no_in_proj_output(ranks):
    """A zamba2 layer's prefill (heads on "model") on data 1 x model 2,
    its input's sequence split: the output and the cache (the raw conv
    window, the SSM state) are the one-device layer's within LOGIT_REL,
    and in_proj runs one product per piece on the heads' columns, so no
    all-gather is as large as the in_proj output (B, S, N)."""
    from repro_torch.models import mamba2 as TM

    case = _hybrid_case()
    _, tcfg, _, model = _setup("hybrid")
    lp = model.blocks[0].leaves()
    with torch.no_grad():
        y, cache = TM.mamba2_forward(case["x"], lp, tcfg, return_cache=True)
    n = lp["in_proj"].shape[1]
    for r in ranks["hybrid-layer"]:
        for got, want in ((r["out"], y), (r["conv"], cache.conv),
                          (r["state"], cache.state)):
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= LOGIT_REL * scale
        assert 0 < r["largest_gather"] < HYBRID_SHAPE[0] * HYBRID_SHAPE[1] \
            * n * 4


@pytest.mark.parametrize("case", ["dense-c3-int8", "dense-c3-4bit",
                                  "moe-c3-int8", "ssm-c3-int8"])
def test_c3_products_run_on_each_ranks_shards(ranks, case):
    """Every C3 product reaches `codebook_matmul` with plain tensors, the
    rank's shards, at every layer of every forward pass: the dense
    fixture's quantized MLP column-parallel (mlp_wi, mlp_wg: N halved)
    and row-parallel (mlp_wo: K halved); the moe fixture's attention
    likewise (wq, wk, wv; wo) and its router whole (replicated for the
    routing; its expert stacks are gathered on each rank's experts); the
    ssm fixture's heads are unsplit, so in the batch of two requests
    in_proj runs on half of each piece's columns (z, x, B, C, dt) and
    out_proj on half of its rows, at prefill (its sequence unsplit) and
    at decode; the batch of one request (its row on every rank) runs both
    whole, as `common.divided_axis` leaves a batch of one."""
    _, tcfg, _, _ = _setup(case)
    d, ff, e = tcfg.d_model, tcfg.d_ff, tcfg.n_experts
    passes = 2 * NEW                 # 2 prefills + 2 x 3 decode steps
    if case.startswith("ssm"):
        d_in, n = 2 * d, tcfg.ssm_state
        h = d_in // tcfg.ssm_head_dim
        want = {(d, 2 * d_in + 2 * n + h), (d_in, d), (d, d_in // 2),
                (d, n // 2), (d, h // 2), (d_in // 2, d)}
        count = tcfg.n_layers * passes // 2 * (6 + 2)
    elif case.startswith("moe"):
        want = {(d, d // 2), (d // 2, d), (d, e)}
        count = 5 * tcfg.n_layers * passes
    else:
        want = {(d, ff // 2), (ff // 2, d)}
        count = 3 * tcfg.n_layers * passes
    for r in ranks[case]:
        calls = r["codebook_products"]
        assert not any(dt for _, _, dt in calls)
        assert {k_n for _, k_n, _ in calls} == want
        assert len(calls) == count


@pytest.mark.parametrize("case", ["dense-c3-int8", "dense-c3-4bit",
                                  "moe-c3-int8"])
def test_serving_param_specs_are_serve_shardings(case, monkeypatch):
    """For a model whose every quantizable leaf is quantized,
    `serving_param_specs` gives `serve_shardings`' p_spec, on both
    meshes of the module."""
    from repro_torch.quant import lm_quant as TQ

    _, tcfg, _, model = _setup(case)
    if case in QUANT_MIN:
        monkeypatch.setattr(TQ, "_QUANT_MIN_SIZE", QUANT_MIN[case])
    for mesh in ({"data": 1, "model": 2}, {"data": 2, "model": 1}):
        want = TST.serve_shardings(tcfg, mesh, SLOTS, CACHE)[1]
        got = TST.serving_param_specs(model, mesh)
        assert got == want
        split = {a for n, s in got.items()
                 if n.endswith((".idx", ".idx4")) for a in s if a}
        # the indexes split over the mesh's axis of two devices
        assert {a for a in split if mesh[a] > 1} == {
            a for a, n in mesh.items() if n > 1}


# ---------------------------------------------------------------------------
# the steps without a mesh, and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dense", "dense-c3-int8"])
def test_steps_without_a_mesh_are_the_one_device_forwards(case):
    """At `mesh=None` the prefill step is `forward_prefill` (without a
    transform, as the reference's; the server's C3 prefill adds it) and
    the decode step `forward_decode`, through the C3 transform under
    quant_serving: equal logits and caches."""
    from repro_torch.quant.lm_quant import make_param_transform

    _, tcfg, _, model = _setup(case)
    batch = {"tokens": torch.tensor(np.stack(_prompts(case)[::2]))}
    pt = make_param_transform(tcfg.dtype) if tcfg.quant_serving else None
    want, wst = TT.forward_prefill(model, tcfg, batch, CACHE,
                                   param_transform=pt)
    if pt is None:
        got, st = TST.make_prefill_step(tcfg, None, CACHE)(model, batch)
        assert torch.equal(got, want)
    else:
        st = TT.forward_prefill(model, tcfg, batch, CACHE,
                                param_transform=pt)[1]
    assert all(torch.equal(a, b) for a, b in zip(st.kv, wst.kv))
    tok = want.argmax(-1, keepdim=True).to(torch.int32)
    got, st = TST.make_decode_step(tcfg, None)(model, st, tok)
    want, wst = TT.forward_decode(model, tcfg, wst, tok, param_transform=pt)
    assert torch.equal(got, want) and int(st.pos) == int(wst.pos) == 13
    assert all(torch.equal(a, b) for a, b in zip(st.kv, wst.kv))


def test_launch_serve_model_parallel_on_cpu(capfd):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "granite-3-2b", "--smoke", "--device",
                       "cpu", "--model-parallel", "2", "--requests", "3",
                       "--prompt-len", "12", "--max-new", "3", "--slots",
                       "2"]) is None
    out = capfd.readouterr().out
    assert out.count("served 3 requests / 9 tokens") == 1
    assert "mesh={'data': 1, 'model': 2}" in out


def test_example_serves_on_the_mesh_then_the_chip(capsys):
    """examples/torch_serve_batched.py on the CPU: 8 requests x 16 tokens
    on the meshed Server (a world of one), one C3 token, 12 + 8 SNN
    requests over two tenants; the process group it started is gone."""
    import importlib.util

    import torch.distributed as dist

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_serve_batched.py"
    spec = importlib.util.spec_from_file_location("torch_serve_batched",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu"])
    assert [len(r.out_tokens) for r in out["lm"]] == [16] * 8
    assert 0 <= out["c3_first_token"] < 1024
    assert len(out["snn"]) == 12 and out["host"]["model_swaps"] >= 1
    assert not dist.is_initialized()
    text = capsys.readouterr().out
    assert "mesh {'data': 1, 'model': 1}" in text
    assert "quantized serving: weight bytes" in text
