"""The port's CUDA kernels on the card: each kernel (fused timestep,
zspe_spmm, codebook_matmul, lif_update, flash_attention) against its plain
version at small shapes and at the shapes that reach its plan's edges
(the codebook product's split of K and lookup table, the flash kernel's
tensor-core and SIMT instantiations), the padded `ops.fused_timestep`
against itself on the CPU, a fused run and an LM prefill counting their
launches.  Marked `cuda`; every test skips without a card.  Run on the
card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import zspe as Z
from repro_torch.kernels import fused_timestep as FT

pytestmark = pytest.mark.cuda

V_ATOL = V_RTOL = 1e-5      # the kernel sums set bits in k order, the
TIE = 1e-4                  # plain version is a matmul


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(dev, seed, m, k, n, density, all_nonzero):
    rng = np.random.default_rng(seed)
    kp = Z.spike_word_count(k) * Z.SPIKE_WORD_BITS
    s = (rng.random((m, k)) < density).astype(np.float32)
    cb = np.sort(rng.normal(0, 0.3, 16)).astype(np.float32)
    if all_nonzero:
        cb[cb == 0] = 1e-3
    else:
        cb[np.argmin(np.abs(cb))] = 0.0
    idx = np.zeros((kp, n), np.int8)
    idx[:k] = rng.integers(0, 16, (k, n))
    cbw = np.broadcast_to(cb[:, None], (16, n)).copy()
    dense = (cb[idx] * (np.arange(kp) < k)[:, None]).astype(np.float32)

    def t(x):
        return torch.tensor(x, device=dev)

    return dict(packed=Z.pack_spike_words(t(s)), idx=t(idx), cbw=t(cbw),
                dense=t(dense), v=t(rng.normal(0.5, 0.5, (m, n))
                                    .astype(np.float32)),
                el=t(rng.integers(0, 6, (m, n)).astype(np.int32)))


@pytest.mark.parametrize("codebook", [True, False], ids=["codebook", "dense"])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("all_nonzero", [False, True])
@pytest.mark.parametrize("partial_update", [True, False],
                         ids=["partial", "full"])
def test_kernel_matches_plain(dev, codebook, density, all_nonzero,
                              partial_update):
    c = _case(dev, 7, 9, 200, 300, density, all_nonzero)
    lif = dict(threshold=1.0, leak=0.9, reset=0.0,
               partial_update=partial_update, all_nonzero=all_nonzero)
    w0, cbw = (c["idx"], c["cbw"]) if codebook else (c["dense"], None)
    want = FT.fused_timestep_plain(c["packed"], w0, cbw, c["v"], c["el"],
                                   **lif)
    v, el = c["v"].clone(), c["el"].clone()
    if codebook:
        got = FT.fused_timestep_codebook(c["packed"], w0, cbw, v, el, **lif)
    else:
        got = FT.fused_timestep_dense(c["packed"], w0, v, el, **lif)
    torch.cuda.synchronize()
    assert got[0] is v and got[1] is el
    for i in (1, 3, 4, 5):
        assert torch.equal(got[i], want[i]), i
    s = Z.unpack_spike_words(c["packed"])
    w = FT._dequant_columns(w0, cbw) if codebook else w0
    decay = (0.9 ** (c["el"] + 1).float()) if partial_update else 0.9
    v_int = c["v"] * decay + s @ w
    near = (v_int - 1.0).abs() < TIE
    if partial_update:
        near &= want[3] > 0
    flip = got[2] != want[2]
    assert not bool((flip & ~near).any())
    keep = ~flip
    torch.testing.assert_close(got[0][keep], want[0][keep], atol=V_ATOL,
                               rtol=V_RTOL)


@pytest.mark.parametrize("codebook", [True, False], ids=["codebook", "dense"])
@pytest.mark.parametrize("block", [None, (8, 128)], ids=["whole", "block"])
def test_ops_fused_timestep_matches_plain(dev, codebook, block):
    """The padded entry point on the card (K to whole spike words, M and N
    to the block) against the same entry point on the CPU."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(11)
    m, k, n = 9, 200, 300
    s = (rng.random((m, k)) < 0.3).astype(np.float32)
    cb = np.sort(rng.normal(0, 0.3, 16)).astype(np.float32)
    cb[np.argmin(np.abs(cb))] = 0.0
    idx = rng.integers(0, 16, (k, n)).astype(np.int8)
    table = np.broadcast_to(cb[:, None], (16, n)).copy()
    v = rng.normal(0.5, 0.5, (m, n)).astype(np.float32)
    el = rng.integers(0, 6, (m, n)).astype(np.int32)
    cpu = [torch.tensor(x) for x in (s, idx if codebook else cb[idx], v, el)]
    tb = torch.tensor(table) if codebook else None
    card = [x.to(dev) for x in cpu]

    name = "fused_timestep_codebook" if codebook else "fused_timestep_dense"
    before = dict(FT.launches)
    got = ops.fused_timestep(*card, block=block,
                             codebook=None if tb is None else tb.to(dev))
    torch.cuda.synchronize()
    assert FT.launches == {**before, name: before[name] + 1}
    assert torch.equal(card[2].cpu(), cpu[2])       # v, elapsed not written
    assert torch.equal(card[3].cpu(), cpu[3])
    want = ops.fused_timestep(*cpu, codebook=tb, block=block)
    got = [t.cpu() for t in got]
    for i in (1, 3, 4, 5):
        assert torch.equal(got[i], want[i]), i
    v_int = torch.tensor(v * 0.9 ** (el + 1).astype(np.float32)
                         + s @ cb[idx])
    flip = got[2] != want[2]
    assert not bool((flip & ~(((v_int - 1.0).abs() < TIE)
                              & (want[3] > 0))).any())
    torch.testing.assert_close(got[0][~flip], want[0][~flip], atol=V_ATOL,
                               rtol=V_RTOL)


def test_fused_run_counts_launches(dev):
    from repro_torch import ChipSimulator, CodebookConfig

    rng = np.random.default_rng(0)
    ws = [rng.normal(0, 0.5, (64, 128)).astype(np.float32),
          rng.normal(0, 0.5, (128, 10)).astype(np.float32)]
    trains = (rng.random((4, 5, 64)) < 0.25).astype(np.float32)
    for qcfg, name in ((CodebookConfig(zero_level=True),
                        "fused_timestep_codebook"),
                       (None, "fused_timestep_dense")):
        sim = ChipSimulator(ws, quant_cfg=qcfg, engine="fused", device=dev)
        FT.reset_launches()
        counts, reports = sim.run_batch(trains)
        torch.cuda.synchronize()
        assert FT.launches[name] == 5 * 2
        assert sum(FT.launches.values()) == 5 * 2
        assert counts.device.type == "cuda" and counts.shape == (4, 10)
        assert all(np.isfinite(r.energy_pj) for r in reports)


# ---------------------------------------------------------------------------
# the kernel API's kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,block", [(100, 300, 50, (64, 128, 32)),
                                         (9, 40, 130, (8, 32, 128)),
                                         (128, 256, 128, (64, 64, 64))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
def test_zspe_spmm_matches_plain(dev, m, k, n, block, dtype):
    from repro_torch.kernels import zspe_spmm as ZS

    rng = np.random.default_rng(m + k + n)
    s = (rng.random((m, k)) < 0.05).astype(np.float32)
    s[:, : k // 2] = 0                        # empty tiles beside busy ones
    st = torch.tensor(s, device=dev).to(dtype)
    w = torch.tensor(rng.normal(0, 1, (k, n)).astype(np.float32), device=dev)
    before = ZS.launches["zspe_spmm"]
    out, skipped = ZS.zspe_spmm(st, w, block=block)
    torch.cuda.synchronize()
    assert ZS.launches["zspe_spmm"] == before + 1
    want, want_skipped = ZS.zspe_spmm_plain(st, w, block)
    assert int(want_skipped.sum()) > 0
    assert torch.equal(skipped, want_skipped)
    torch.testing.assert_close(out, want, atol=V_ATOL, rtol=V_RTOL)


@pytest.mark.parametrize("m,k,n,levels", [(1, 1, 1, 4), (37, 200, 180, 8),
                                          (130, 70, 3, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_codebook_matmul_matches_plain(dev, m, k, n, levels, dtype):
    from repro_torch.kernels import codebook_matmul as CBM

    rng = np.random.default_rng(m + k + n)
    x = torch.tensor(rng.normal(0, 1, (m, k)).astype(np.float32),
                     device=dev).to(dtype)
    idx = torch.tensor(rng.integers(0, levels, (k, n)).astype(np.int8),
                       device=dev)
    cb = torch.tensor(np.sort(rng.normal(0, 1, levels)).astype(np.float32),
                      device=dev)
    out = CBM.codebook_matmul(x, idx, cb)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, CBM.codebook_matmul_plain(x, idx, cb),
                               atol=V_ATOL, rtol=V_RTOL)


# the paper's network (configs/snn_chip.py ARCH) at one step, M = 32
ARCH_SHAPES = [(32, 2312, 4096), (32, 4096, 1024), (32, 1024, 10)]


@pytest.mark.parametrize("m,k,n", ARCH_SHAPES + [(32, 1000, 10),
                                                 (32, 4100, 1024),
                                                 (200, 999, 37), (32, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_codebook_matmul_plan_edges_match_exact(dev, m, k, n, dtype):
    """The split-K plan at the ARCH shapes and at K that the split does
    not divide, against the f64 product the kernel computes (f64 sums,
    one rounding); levels at the ARCH scale N(0, 2/sqrt(K))."""
    from repro_torch.kernels import codebook_matmul as CBM

    rng = np.random.default_rng(m + k + n)
    x = torch.tensor(rng.normal(0, 1, (m, k)).astype(np.float32),
                     device=dev).to(dtype)
    idx = torch.tensor(rng.integers(0, 16, (k, n)).astype(np.int8),
                       device=dev)
    cb = torch.tensor(np.sort(rng.normal(0, 2 / np.sqrt(k), 16))
                      .astype(np.float32), device=dev)
    before = CBM.launches["codebook_matmul"]
    out = CBM.codebook_matmul(x, idx, cb)
    torch.cuda.synchronize()
    assert CBM.launches["codebook_matmul"] == before + 1
    want = (x.double() @ CBM.dequantize(idx, cb).double()).float()
    torch.testing.assert_close(out, want, atol=V_ATOL, rtol=V_RTOL)


@pytest.mark.parametrize("m,k,n", ARCH_SHAPES + [(37, 200, 180)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_codebook_matmul_out_of_range_indexes_contribute_zero(dev, m, k, n,
                                                              dtype):
    """Indexes outside [0, L) — negative bytes and 8..20 with L = 8 — hit
    the zero entries of the kernel's 256-entry lookup table."""
    from repro_torch.kernels import codebook_matmul as CBM

    rng = np.random.default_rng(k + n)
    x = torch.tensor(rng.normal(0, 1, (m, k)).astype(np.float32),
                     device=dev).to(dtype)
    ix = rng.integers(-20, 21, (k, n)).astype(np.int8)
    ix[0, :2] = (16, -128)
    idx = torch.tensor(ix, device=dev)
    cb = torch.tensor(np.sort(rng.normal(0, 2 / np.sqrt(k), 8))
                      .astype(np.float32), device=dev)
    out = CBM.codebook_matmul(x, idx, cb)
    torch.cuda.synchronize()
    want = (x.double() @ CBM.dequantize(idx, cb).double()).float()
    torch.testing.assert_close(out, want, atol=V_ATOL, rtol=V_RTOL)
    torch.testing.assert_close(out, CBM.codebook_matmul_plain(x, idx, cb),
                               atol=V_ATOL, rtol=V_RTOL)


def test_lif_update_matches_plain(dev):
    from repro_torch.kernels import lif_update as LU

    rng = np.random.default_rng(5)
    shape = (37, 300)
    v = torch.tensor(rng.normal(0.3, 0.6, shape).astype(np.float32),
                     device=dev)
    el = torch.tensor(rng.integers(0, 40, shape).astype(np.int32), device=dev)
    cur = rng.normal(0, 1.5, shape).astype(np.float32)
    cur[rng.random(shape) < 0.5] = 0.0
    cur[rng.random(shape) < 0.1] = -0.0
    cur = torch.tensor(cur, device=dev)
    got = LU.lif_update(v, el, cur, threshold=1.0, leak=0.9)
    torch.cuda.synchronize()
    want = LU.lif_update_plain(v, el, cur, threshold=1.0, leak=0.9, reset=0.0)
    for i in (1, 3):
        assert torch.equal(got[i], want[i]), i
    v_int = v * 0.9 ** (el + 1).float() + cur
    flip = got[2] != want[2]
    assert not bool((flip & ((v_int - 1.0).abs() >= TIE)).any())
    torch.testing.assert_close(got[0][~flip], want[0][~flip], atol=V_ATOL,
                               rtol=V_RTOL)


# ---------------------------------------------------------------------------
# flash attention against its plain version
# ---------------------------------------------------------------------------

FLASH_F32_TOL = 2e-5    # online against one-pass softmax, f32
FLASH_BF16_TOL = 2e-2   # p and the output rounded to bf16 in the kernel


def _flash_inputs(dev, seed, b, h, kv, s, t, hd, dtype):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(0, 1, shape).astype(np.float32),
                         device=dev).to(dtype)
            for shape in ((b, h, s, hd), (b, kv, t, hd), (b, kv, t, hd))]


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_matches_plain(dev, hd, group, causal, dtype):
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(dev, hd + group, 2, 8, 8 // group, 256, 384, hd,
                            dtype)
    before = FA.launches["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = FA.flash_attention_plain(q, k, v, causal)
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    rtol = tol if dtype == torch.float32 else 0.0
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=rtol)


@pytest.mark.parametrize("b,h,kv,s,t,hd,dtype", [
    (2, 8, 2, 256, 256, 32, torch.bfloat16),       # SIMT bf16
    (2, 8, 2, 256, 256, 32, torch.float32),
    (4, 32, 8, 512, 512, 64, torch.bfloat16),      # the served shape
    (4, 32, 8, 512, 512, 128, torch.bfloat16),     # granite-3-8b's
    (2, 8, 2, 128, 512, 64, torch.bfloat16),       # T > S
    (2, 8, 2, 128, 512, 128, torch.bfloat16),
    (2, 8, 8, 384, 256, 64, torch.bfloat16),       # S > T
], ids=["hd32-bf16", "hd32-f32", "served", "hd128-served", "t>s-hd64",
        "t>s-hd128", "s>t-hd64"])
def test_flash_attention_causal_shapes_match_plain(dev, b, h, kv, s, t, hd,
                                                   dtype):
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(dev, s + t + hd, b, h, kv, s, t, hd, dtype)
    before = dict(FA.launches)
    got = FA.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    wgmma = FA._route(dtype, hd) == "wgmma"
    assert FA.launches == {
        "flash_attention": before["flash_attention"] + 1,
        "flash_attention_wgmma": before["flash_attention_wgmma"] + wgmma}
    want = FA.flash_attention_plain(q, k, v, True)
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    rtol = tol if dtype == torch.float32 else 0.0
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=rtol)


def test_flash_attention_counts_only_kernel_launches(dev):
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(dev, 0, 1, 2, 2, 128, 128, 64, torch.bfloat16)
    FA.reset_launches()
    FA.flash_attention(q, k, v)
    FA.flash_attention(q, k, v, causal=False)
    FA.flash_attention_plain(q, k, v)
    FA.flash_attention(q.cpu(), k.cpu(), v.cpu())     # plain version
    torch.cuda.synchronize()
    assert FA.launches == {"flash_attention": 2, "flash_attention_wgmma": 2}
    FA.flash_attention(q.float(), k.float(), v.float())   # the SIMT kernel
    torch.cuda.synchronize()
    assert FA.launches == {"flash_attention": 3, "flash_attention_wgmma": 2}


def test_flash_attention_rejects_bad_operands(dev):
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(dev, 1, 1, 2, 2, 256, 256, 64, torch.float32)
    FA.reset_launches()
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           k, v)
    with pytest.raises(TypeError, match="q must be"):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="multiples of 128"):
        FA.flash_attention(q[:, :, :200].contiguous(), k, v)
    with pytest.raises(ValueError, match="head dim 48"):
        FA.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           v[..., :48].contiguous())
    with pytest.raises(ValueError, match="16-byte aligned"):
        qb = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)
        FA.flash_attention(qb[1:].view(q.shape), k.bfloat16(), v.bfloat16())
    assert FA.launches == {"flash_attention": 0, "flash_attention_wgmma": 0}


def test_lm_prefill_takes_the_flash_kernel(dev):
    """The SMOKE granite model at S = 256 launches the kernel once per
    layer; decode at S = 1 takes the plain SDPA."""
    import dataclasses

    from repro_torch.configs import registry as R
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(R.get_arch("granite-3-2b", smoke=True),
                              dtype=torch.float32)
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 256), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    FA.reset_launches()
    logits, st = T.forward_prefill(model, cfg, {"tokens": toks}, 264)
    T.forward_decode(model, cfg, st, toks[:, :1])
    torch.cuda.synchronize()
    assert FA.launches == {"flash_attention": cfg.n_layers,
                           "flash_attention_wgmma": 0}   # f32: SIMT
    assert logits.shape == (2, cfg.vocab) and bool(logits.isfinite().all())
