"""The port's CUDA kernels on the card: each kernel (fused timestep,
zspe_spmm, codebook_matmul, lif_update, flash_attention) against its plain
version at small shapes and at the shapes that reach its plan's edges
(the fused kernels' tiles, level table and out-of-range indexes, Gaussian
dense weights with 0.0 and -0.0, weights not 16-byte aligned; lif_update's
ragged counts, unaligned operands and long elapsed; the codebook product's
split of K and lookup table, the flash kernel's tensor-core and SIMT
instantiations), the padded `ops.fused_timestep`
against itself on the CPU, a fused run and an LM prefill counting their
launches; a faulted ARCH chip's layer-steps against the plain versions,
its traced run's launches, and the drop masks drawn on the card bitwise
equal to the CPU's; plastic fused runs (STDP, R-STDP) counting their
launches and learning the compiled engine's indexes, and the interpretive
engine learning them a sample at a time; `SnnServer` groups equal to
their padded batch's rows, its retry and degraded paths, one QAT
training step against the same step on the CPU, and codebook fits
(`quant.quantize`, bitwise) and per-core PTQ
(`deploy.fit_per_core_codebooks`) against the CPU's; C3-quantized LM
products (`models.common.linear` on a codebook operand) at the decode
shapes, `moe_ffn` and a 4-bit quantized model against the CPU; one
mamba2 layer against the CPU and whisper's decoder prefill on the flash
kernel; one tensor-parallel training step (data 1 x model 2) on two
gloo ranks on the card against the same step on the CPU; a C3 product
on DTensor operands (column- and row-parallel, int8 and 4-bit) launching
the codebook kernel on the rank's shards, and a meshed C3 prefill on a
1 x 1 NCCL mesh against the one-device one.  Marked `cuda`; every test skips without a card.  Run on the
card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

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


def _case(dev, seed, m, k, n, density, all_nonzero, levels=16, lo=0,
          hi=None, gauss=False):
    """Indexes from [lo, hi) (default [0, levels)); the dense weights are
    their levels, 0 outside [0, L), or with `gauss` Gaussian f32 with a
    tenth 0.0 and a tenth -0.0 (none with all_nonzero)."""
    rng = np.random.default_rng(seed)
    kp = Z.spike_word_count(k) * Z.SPIKE_WORD_BITS
    s = (rng.random((m, k)) < density).astype(np.float32)
    cb = np.sort(rng.normal(0, 0.3, levels)).astype(np.float32)
    if all_nonzero:
        cb[cb == 0] = 1e-3
    else:
        cb[np.argmin(np.abs(cb))] = 0.0
    idx = np.zeros((kp, n), np.int8)
    idx[:k] = rng.integers(lo, levels if hi is None else hi, (k, n))
    cbw = np.broadcast_to(cb[:, None], (levels, n)).copy()
    ix = idx.astype(np.int64)
    dense = np.where((ix >= 0) & (ix < levels),
                     cb[np.clip(ix, 0, levels - 1)], 0.0)
    dense = (dense * (np.arange(kp) < k)[:, None]).astype(np.float32)
    if gauss:
        dense[:k] = rng.normal(0, 0.3, (k, n))
        if not all_nonzero:
            share = rng.random((k, n))
            dense[:k][share < 0.1] = 0.0
            dense[:k][(share >= 0.1) & (share < 0.2)] = -0.0

    def t(x):
        return torch.tensor(x, device=dev)

    return dict(packed=Z.pack_spike_words(t(s)), idx=t(idx), cbw=t(cbw),
                dense=t(dense), v=t(rng.normal(0.5, 0.5, (m, n))
                                    .astype(np.float32)),
                el=t(rng.integers(0, 6, (m, n)).astype(np.int32)))


# (M, K, N, L, lo, hi of the int8 indexes): the first as before; then the
# codebook kernel's plan edges (kernels/fused_timestep.py `_plan`): one
# spike word, Kw = 9 (a split of 8 does not divide it), N = 10 and 37
# (index rows not 16-byte aligned), one row, a ragged row tile, a whole
# run's 640 rows; L = 1 and 200 (only 0..127 reachable); indexes outside
# [0, L) (negative ones and ones >= L)
FUSED_CASES = {
    "base": (9, 200, 300, 16, 0, 16), "kw1": (32, 16, 128, 16, 0, 16),
    "kw9": (32, 144, 256, 16, 0, 16), "n10": (32, 1000, 10, 16, 0, 16),
    "n37": (32, 999, 37, 16, 0, 16), "m1": (1, 2312, 4096, 16, 0, 16),
    "ragged": (200, 999, 37, 16, 0, 16), "m640": (640, 2312, 4096, 16, 0, 16),
    "L1": (32, 1024, 256, 1, 0, 1), "L200": (32, 1024, 256, 200, -128, 128),
    "out-of-range": (32, 999, 64, 8, -20, 21)}


@pytest.mark.parametrize("case", list(FUSED_CASES))
@pytest.mark.parametrize("codebook", [True, False], ids=["codebook", "dense"])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("all_nonzero", [False, True])
@pytest.mark.parametrize("partial_update", [True, False],
                         ids=["partial", "full"])
def test_kernel_matches_plain(dev, case, codebook, density, all_nonzero,
                              partial_update):
    """Against the plain version at FUSED_CASES; a second call on the same
    inputs bitwise equal to the first."""
    m, k, n, levels, lo, hi = FUSED_CASES[case]
    c = _case(dev, 7, m, k, n, density, all_nonzero, levels, lo, hi)
    w0, cbw = (c["idx"], c["cbw"]) if codebook else (c["dense"], None)
    _assert_matches_plain(c, w0, cbw, all_nonzero, partial_update)


def _assert_matches_plain(c, w0, cbw, all_nonzero, partial_update,
                          exact=False):
    """The fused kernel (codebook when `cbw` is given) against the plain
    version on case `c` with weights `w0`; a second call on the same inputs
    bitwise equal to the first.  With `exact`, v' is held to the LIF step
    on the current summed in f64 and rounded once, as the kernel sums it:
    the plain version's f32 matmul rounds over up to K terms, and Gaussian
    weights of N(0, 0.3) at K = 2312, density 0.3, moved its v' by 1.3e-5
    where the currents (about +-8) cancelled."""
    codebook = cbw is not None
    lif = dict(threshold=1.0, leak=0.9, reset=0.0,
               partial_update=partial_update, all_nonzero=all_nonzero)
    want = FT.fused_timestep_plain(c["packed"], w0, cbw, c["v"], c["el"],
                                   **lif)
    call = FT.fused_timestep_codebook if codebook else \
        (lambda p, w, _, v, el, **kw: FT.fused_timestep_dense(p, w, v, el,
                                                              **kw))
    v, el = c["v"].clone(), c["el"].clone()
    got = call(c["packed"], w0, cbw, v, el, **lif)
    again = call(c["packed"], w0, cbw, c["v"].clone(), c["el"].clone(),
                 **lif)
    torch.cuda.synchronize()
    assert got[0] is v and got[1] is el
    for a, b in zip(got, again):
        assert torch.equal(a, b)
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
    v_want = want[0]
    if exact:
        cur = (s.double() @ w.double()).float()
        fed = want[3] > 0 if partial_update else torch.ones_like(keep)
        v_want = torch.where(want[2] > 0, torch.zeros_like(cur),
                             torch.where(fed, c["v"] * decay + cur, c["v"]))
    torch.testing.assert_close(got[0][keep], v_want[keep], atol=V_ATOL,
                               rtol=V_RTOL)


# FUSED_CASES whose indexes span [0, L): the shapes for Gaussian weights
GAUSS_CASES = [name for name, (*_, levels, lo, hi) in FUSED_CASES.items()
               if (lo, hi) == (0, levels)]


@pytest.mark.parametrize("case", GAUSS_CASES)
@pytest.mark.parametrize("density", [0.05, 0.3, 1.0])
@pytest.mark.parametrize("all_nonzero", [False, True])
@pytest.mark.parametrize("partial_update", [True, False],
                         ids=["partial", "full"])
def test_dense_gaussian_weights_match_plain(dev, case, density, all_nonzero,
                                            partial_update):
    """The dense kernel on Gaussian f32 weights, 0.0 and -0.0 among them
    (neither touches a neuron), against the plain version, v' against the
    f64 product."""
    m, k, n, *_ = FUSED_CASES[case]
    c = _case(dev, 8, m, k, n, density, all_nonzero, gauss=True)
    _assert_matches_plain(c, c["dense"], None, all_nonzero, partial_update,
                          exact=True)


def _misaligned(t):
    """A contiguous copy of `t` at storage offset 1 (not 16-byte aligned)."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype,
                      device=t.device)[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("m,k,n", [(32, 999, 64), (128, 1000, 512),
                                   (640, 512, 1000)])
@pytest.mark.parametrize("codebook", [True, False], ids=["codebook", "dense"])
def test_fused_weights_off_alignment_match_plain(dev, m, k, n, codebook):
    """Weights at storage offset 1 (the kernels' narrow-copy path) and
    N = 1000 (dense copies past N in the last tile)."""
    c = _case(dev, 9, m, k, n, 0.2, False, gauss=not codebook)
    w0, cbw = (c["idx"], c["cbw"]) if codebook else (c["dense"], None)
    _assert_matches_plain(c, _misaligned(w0), cbw, False, True, exact=True)
    _assert_matches_plain(c, w0, cbw, False, True, exact=True)


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


@pytest.fixture(scope="module")
def faulted_arch():
    """Quantized and float simulators of the paper's network (ARCH) on the
    card under one fault plan: a dead core of layer 2, router 2 and a
    link on a layer-1 route failed (blocks cut), a bit-flip and a stuck
    codebook word (quantized only), per-hop drop 0.05."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import ChipSimulator, CodebookConfig, quantize
    from repro_torch.configs.snn_chip import ARCH
    from repro_torch.faults import CodebookFault, FaultConfig

    rng = np.random.default_rng(0)
    sizes = ARCH.layer_sizes
    ws = [rng.normal(0, 2.0 / np.sqrt(a), (a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    qcfg = CodebookConfig(n_levels=16, bit_width=8, zero_level=True)
    qws = [quantize(w, qcfg, device="cuda") for w in ws]
    healthy = ChipSimulator(qws, engine="fused", device="cuda")
    m = healthy.mapping
    src, dst = m.cores_of_layer(1)[0], m.cores_of_layer(2)[0]
    path = healthy.routing.path(src.core_id, dst.core_id)
    words = healthy.register_tables[m.assignments.index(src)].codebook_words
    faults = FaultConfig(
        dead_cores=(m.cores_of_layer(2)[-1].core_id,), failed_routers=(2,),
        failed_links=(tuple(path[:2]),), drop_p=0.05, seed=7)
    cbf = (CodebookFault(core_id=src.core_id,
                         word=int(np.argmax(np.abs(words))), bit=0),)
    quant = ChipSimulator(qws, engine="fused", mapping=m, device="cuda",
                          faults=dataclasses.replace(faults,
                                                     codebook_faults=cbf))
    dense = ChipSimulator(ws, engine="fused", mapping=m, device="cuda",
                          faults=faults)
    return {"codebook": quant, "dense": dense}


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("kind", ["codebook", "dense"])
@pytest.mark.parametrize("partial_update", [True, False],
                         ids=["partial", "full"])
def test_faulted_arch_layer_steps_match_plain(faulted_arch, kind, layer,
                                              partial_update):
    """A faulted chip's lowered ARCH weights (zeroed columns and blocks, a
    corrupted codebook column) under spikes thinned by the drop plan's
    masks, M = 32: the kernel against its plain version."""
    sim = faulted_arch[kind]
    eng = sim.fused_engine()
    assert eng.codebook_layers == (3 if kind == "codebook" else 0)
    lw = eng.fused_weights[layer]
    rng = np.random.default_rng(layer)
    s = torch.tensor((rng.random((32, lw.n_pre)) < 0.1).astype(np.float32),
                     device="cuda")
    masks = eng._drop_masks(20)
    if layer and masks[layer - 1] is not None:
        s = s * masks[layer - 1][7]
    c = dict(packed=Z.pack_spike_words(s),
             v=torch.tensor(rng.normal(0.5, 0.5, (32, lw.n_post)).astype(
                 np.float32), device="cuda"),
             el=torch.tensor(rng.integers(0, 6, (32, lw.n_post)).astype(
                 np.int32), device="cuda"))
    w0, cbw = (lw.idx, lw.cbw) if kind == "codebook" else (lw.dense, None)
    _assert_matches_plain(c, w0, cbw, lw.all_nonzero, partial_update,
                          exact=True)


@pytest.mark.parametrize("n", [1, 10, 4096])
def test_drop_masks_on_the_card_equal_the_cpu(dev, n):
    from repro_torch.faults import DropPlan, derive_fault_seed

    rng = np.random.default_rng(n)
    keep = tuple(np.float32(0.95 ** rng.integers(1, 20, n))
                 for _ in range(3))
    for seed in (0, 2**32 - 1, derive_fault_seed(7, 4)):
        plan = DropPlan(key_seed=seed, keep_p=keep)
        for li in range(3):
            got = plan.masks(li, 1001, dev)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), plan.masks(li, 1001, "cpu"))
            assert torch.equal(plan.mask(li, 1000, dev).cpu(),
                               plan.mask(li, 1000, "cpu"))


def test_faulted_traced_run_counts_launches(faulted_arch):
    from repro_torch import ChipSimulator
    from repro_torch.telemetry import TraceConfig

    base = faulted_arch["codebook"]
    sim = ChipSimulator(base.qweights, engine="fused", mapping=base.mapping,
                        faults=base.faults, trace=TraceConfig(enabled=True),
                        device="cuda")
    trains = (np.random.default_rng(1).random((8, 4, 2312))
              < 0.1).astype(np.float32)
    FT.reset_launches()
    counts, reports = sim.run_batch(trains)
    torch.cuda.synchronize()
    assert FT.launches == {"fused_timestep_codebook": 12,
                           "fused_timestep_dense": 0}
    trace = sim.last_trace()
    assert trace.fired.shape[:2] == (8, 4)
    np.testing.assert_allclose(trace.wall_cycles(),
                               [r.wall_cycles for r in reports], rtol=1e-9)


# ---------------------------------------------------------------------------
# plasticity and the interpretive engine on the card (chip_smoke.py phase
# 8 at a small size)
# ---------------------------------------------------------------------------

PLASTIC_SIZES = (64, 96, 96, 16)
PLASTIC_RULES = {
    "stdp": dict(enabled=True, mode="stdp", lr=0.4, layers=(1, 2)),
    "reward": dict(enabled=True, mode="reward", lr=0.05, elig_pre=0.5,
                   layers=(2,)),
}


def _plastic_sim(dev, rule, engine, mapping=None, trace=False):
    from repro_torch import ChipSimulator, CodebookConfig, PlasticityConfig
    from repro_torch.telemetry import TraceConfig

    rng = np.random.default_rng(0)
    ws = [rng.normal(0, 1.2 / np.sqrt(a), (a, b)).astype(np.float32)
          for a, b in zip(PLASTIC_SIZES[:-1], PLASTIC_SIZES[1:])]
    return ChipSimulator(ws, quant_cfg=CodebookConfig(8, 8), engine=engine,
                         mapping=mapping, device=dev,
                         trace=TraceConfig(enabled=True) if trace else None,
                         plasticity=PlasticityConfig(**PLASTIC_RULES[rule]))


def _same_frozen(ys_a, ys_b, frozen):
    """Samples whose frozen layers fired the same per-core counts at every
    step in both runs."""
    same = torch.ones(ys_a["fired"].shape[0], dtype=torch.bool,
                      device=ys_a["fired"].device)
    for li in frozen:
        same &= (ys_a[f"fired_core_{li}"] == ys_b[f"fired_core_{li}"]
                 ).flatten(1).all(1)
    return same


@pytest.mark.parametrize("rule", list(PLASTIC_RULES))
def test_plastic_fused_run_on_the_card(dev, rule):
    """Frozen layers launch the kernel once a step, learnable ones none;
    in every sample whose frozen layers fired as the compiled engine's,
    learned indexes and writes are bitwise the compiled engine's."""
    fused = _plastic_sim(dev, rule, "fused")
    comp = _plastic_sim(dev, rule, "compiled", mapping=fused.mapping)
    layers = PLASTIC_RULES[rule]["layers"]
    frozen = [li for li in range(3) if li not in layers]
    trains = (np.random.default_rng(1).random((8, 6, PLASTIC_SIZES[0]))
              < 0.25).astype(np.float32)
    FT.reset_launches()
    ys_f, counts = fused.fused_engine().run_raw(trains)
    torch.cuda.synchronize()
    assert FT.launches == {"fused_timestep_codebook": 6 * len(frozen),
                           "fused_timestep_dense": 0}
    ys_c, _ = comp.compiled_engine().run_raw(trains)
    same = _same_frozen(ys_f, ys_c, frozen)
    assert bool(same.any())
    assert torch.equal(ys_f["writes"][same], ys_c["writes"][same])
    for li in layers:
        key = f"learned_idx_{li}"
        assert ys_f[key].device.type == "cuda"
        assert torch.equal(ys_f[key][same], ys_c[key][same])
    if rule == "stdp":
        assert float(ys_f["writes"].sum()) > 0
    else:
        fused.run_batch(trains)
        comp.run_batch(trains)
        reward = torch.zeros(PLASTIC_SIZES[-1])
        reward[3], reward[7] = 1.0, -1.0
        info_f, info_c = fused.apply_reward(reward), comp.apply_reward(reward)
        rows = same.cpu().numpy()
        for k in info_c:
            np.testing.assert_array_equal(info_f[k][rows], info_c[k][rows])
        assert torch.equal(fused.last_learned[2][same],
                           comp.last_learned[2][same])


def test_reference_engine_on_the_card(dev):
    """The interpretive engine, STDP traced, launches no kernel and learns
    what the compiled engine learns a sample at a time."""
    ref = _plastic_sim(dev, "stdp", "reference", trace=True)
    comp = _plastic_sim(dev, "stdp", "compiled", mapping=ref.mapping,
                        trace=True)
    trains = (np.random.default_rng(2).random((2, 6, PLASTIC_SIZES[0]))
              < 0.25).astype(np.float32)
    FT.reset_launches()
    counts, reports = ref.run_batch(trains)
    torch.cuda.synchronize()
    assert sum(FT.launches.values()) == 0
    assert counts.device.type == "cuda"
    trace = ref.last_trace()
    np.testing.assert_array_equal(trace.weight_writes.sum(axis=(1, 2)),
                                  [r.stats.weight_writes for r in reports])
    held = 0
    for b in range(2):
        ys, c = comp.compiled_engine().run_raw(trains[b:b + 1])
        fired0 = ys["fired_core_0"][0].cpu().numpy()
        if not np.array_equal(fired0,
                              trace.fired[b][:, trace.slice_layer == 0]):
            continue                  # a near-tie flip in the frozen layer
        held += 1
        assert torch.equal(c[0], counts[b])
        for li in (1, 2):
            assert torch.equal(ys[f"learned_idx_{li}"][0],
                               ref.last_learned[li][b])
        np.testing.assert_array_equal(ys["writes"][0].cpu().numpy(),
                                      trace.weight_writes[b])
    assert held


# ---------------------------------------------------------------------------
# the kernel API's kernels against their plain versions
# ---------------------------------------------------------------------------

# (M, K, N, caller's block): the first three as before (they hold empty
# tiles beside busy ones, so some tile is skipped); then the kernel
# plan's edges: K = 1, K = 999 (no split divides it) with N = 10, M = 200
# (a ragged 32-row tile and caller tiles of 128 rows) with N = 37 (rows
# not 16-byte aligned: element loads), and the ARCH layers 1 and 2 at one
# step (M = 32), where the split fills the card
ZSPE_CASES = [(100, 300, 50, (64, 128, 32)), (9, 40, 130, (8, 32, 128)),
              (128, 256, 128, (64, 64, 64)), (32, 1, 64, (32, 8, 64)),
              (32, 999, 10, (32, 128, 8)), (200, 1000, 37, (128, 128, 32)),
              (32, 2312, 4096, (32, 128, 128)),
              (32, 4096, 1024, (32, 128, 128))]
# spike values: {0, 1}; other levels ({0, 0.5, 1, 2}, int8 {0, 1, 2, -3}),
# which the kernel multiplies by; an all-zero and an all-one tile
ZSPE_VALUES = ["binary", "levels", "zeros", "ones"]


def _zspe_spikes(rng, m, k, kind, dtype):
    s = (rng.random((m, k)) < 0.05).astype(np.float32)
    s[:, : k // 2] = 0                        # empty tiles beside busy ones
    if kind == "levels":
        lv = ((0.0, 0.5, 1.0, 2.0) if dtype == torch.float32
              else (0.0, 1.0, 2.0, -3.0))
        s = s * np.asarray(lv, np.float32)[rng.integers(1, 4, (m, k))]
    elif kind == "zeros":
        s[:] = 0
    elif kind == "ones":
        s[:] = 1
    return s


@pytest.mark.parametrize("m,k,n,block", ZSPE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
@pytest.mark.parametrize("kind", ZSPE_VALUES)
def test_zspe_spmm_matches_plain(dev, m, k, n, block, dtype, kind):
    """Against the f64 product the kernel computes (f64 sums in k order,
    one rounding), counters equal to the plain version's, one launch per
    call, and two calls bitwise equal (the cluster adds its partial
    tiles in rank order)."""
    from repro_torch.kernels import zspe_spmm as ZS

    rng = np.random.default_rng(m + k + n)
    s = _zspe_spikes(rng, m, k, kind, dtype)
    st = torch.tensor(s, device=dev).to(dtype)
    w = torch.tensor(rng.normal(0, 1, (k, n)).astype(np.float32), device=dev)
    before = ZS.launches["zspe_spmm"]
    out, skipped = ZS.zspe_spmm(st, w, block=block)
    again, skipped_again = ZS.zspe_spmm(st, w, block=block)
    torch.cuda.synchronize()
    assert ZS.launches["zspe_spmm"] == before + 2
    _, want_skipped = ZS.zspe_spmm_plain(st, w, block)
    if kind == "zeros" or (kind != "ones" and (m, k, n, block)
                           in ZSPE_CASES[:3]):
        assert int(want_skipped.sum()) > 0
    assert torch.equal(skipped, want_skipped)
    assert torch.equal(skipped_again, want_skipped)
    want = (st.double() @ w.double()).float()
    torch.testing.assert_close(out, want, atol=V_ATOL, rtol=V_RTOL)
    assert torch.equal(out, again)


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


LIF_EDGE_SHAPES = [(1, 10), (1, 37), (3, 37), (37, 10), (1, 4096),
                   (32, 4096)]


@pytest.mark.parametrize("shape", LIF_EDGE_SHAPES)
@pytest.mark.parametrize("offset", [None, 0, 1, 2],
                         ids=["aligned", "v-offset", "elapsed-offset",
                              "current-offset"])
def test_lif_update_edges_match_plain(dev, shape, offset):
    """Element counts that four does not divide, one operand at storage
    offset 1 (not 16-byte aligned), elapsed up to 99; two calls bitwise
    equal."""
    from repro_torch.kernels import lif_update as LU

    rng = np.random.default_rng(sum(shape))
    v = torch.tensor(rng.normal(0.3, 0.6, shape).astype(np.float32),
                     device=dev)
    el = torch.tensor(rng.integers(0, 100, shape).astype(np.int32),
                      device=dev)
    cur = rng.normal(0, 1.5, shape).astype(np.float32)
    cur[rng.random(shape) < 0.4] = 0.0
    cur[rng.random(shape) < 0.1] = -0.0
    ops = [v, el, torch.tensor(cur, device=dev)]
    if offset is not None:
        ops[offset] = _misaligned(ops[offset])
    got = LU.lif_update(*ops, threshold=1.0, leak=0.9)
    again = LU.lif_update(*ops, threshold=1.0, leak=0.9)
    want = LU.lif_update_plain(*ops, threshold=1.0, leak=0.9, reset=0.0)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for i in (1, 3):
        assert torch.equal(got[i], want[i]), i
    v_int = ops[0] * 0.9 ** (ops[1] + 1).float() + ops[2]
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


@pytest.mark.parametrize("hd", [16, 64, 80, 96, 128])
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


@pytest.mark.parametrize("b,h,kv,s,t,hd,dtype,causal", [
    (2, 8, 2, 256, 256, 32, torch.bfloat16, True),     # SIMT bf16
    (2, 8, 2, 256, 256, 32, torch.float32, True),
    (4, 32, 8, 512, 512, 64, torch.bfloat16, True),    # the served shape
    (4, 32, 8, 512, 512, 128, torch.bfloat16, True),   # granite-3-8b's
    (2, 8, 2, 128, 512, 64, torch.bfloat16, True),     # T > S
    (2, 8, 2, 128, 512, 128, torch.bfloat16, True),
    (2, 8, 8, 384, 256, 64, torch.bfloat16, True),     # S > T
    (4, 32, 32, 640, 640, 96, torch.bfloat16, True),   # phi-3-vision's
    (2, 8, 2, 128, 512, 96, torch.bfloat16, True),
    (2, 8, 8, 384, 256, 96, torch.bfloat16, True),
    (2, 8, 2, 256, 384, 96, torch.bfloat16, False),
], ids=["hd32-bf16", "hd32-f32", "served", "hd128-served", "t>s-hd64",
        "t>s-hd128", "s>t-hd64", "phi3-prefill-hd96", "t>s-hd96",
        "s>t-hd96", "full-gqa4-hd96"])
def test_flash_attention_causal_shapes_match_plain(dev, b, h, kv, s, t, hd,
                                                   dtype, causal):
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(dev, s + t + hd, b, h, kv, s, t, hd, dtype)
    before = dict(FA.launches)
    got = FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    wgmma = FA._route(dtype, hd) == "wgmma"
    assert wgmma == (dtype == torch.bfloat16 and hd in (64, 96, 128))
    assert FA.launches == {
        "flash_attention": before["flash_attention"] + 1,
        "flash_attention_wgmma": before["flash_attention_wgmma"] + wgmma}
    want = FA.flash_attention_plain(q, k, v, causal)
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    rtol = tol if dtype == torch.float32 else 0.0
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=rtol)


def test_flash_attention_hd96_columns_land_in_place(dev):
    """bf16 hd 96 on the tensor-core kernel with V's columns unlike one
    another (v rising with the column, plus noise): a 32-column panel
    stored at the wrong column offset or row stride, or a zero-filled
    tail, would show far beyond the tolerance."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_inputs(dev, 96, 2, 8, 8, 384, 384, 96, torch.bfloat16)
    v = (torch.arange(96, device=dev) / 96 + 0.1 * v.float()).to(v.dtype)
    before = FA.launches["flash_attention_wgmma"]
    got = FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention_wgmma"] == before + 1
    want = FA.flash_attention_plain(q, k, v, True)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_BF16_TOL, rtol=0.0)


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
    # hd 96 (192-byte rows) on the tensor cores: an unaligned base raises
    # too, and does not fall back to the SIMT kernel
    q96, k96, v96 = _flash_inputs(dev, 2, 1, 2, 2, 256, 256, 96,
                                  torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kb = torch.empty(k96.numel() + 1, dtype=torch.bfloat16, device=dev)
        FA.flash_attention(q96, kb[1:].view(k96.shape), v96)
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


# ---------------------------------------------------------------------------
# SNN serving and training on the card


def _serve_sim(dev, seed=0, **kw):
    from repro_torch import ChipSimulator, CodebookConfig, quantize

    rng = np.random.default_rng(seed)
    sizes = (64, 96, 96, 16)
    qws = [quantize(rng.normal(0, 1.2 / np.sqrt(a), (a, b)).astype(
        np.float32), CodebookConfig(8, 8), device=dev)
        for a, b in zip(sizes[:-1], sizes[1:])]
    return ChipSimulator(qws, engine="fused", device=dev, **kw)


def _serve_trains(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 6, 64)) < 0.25).astype(np.float32)


def _slot_batch(group, slots):
    batch = np.zeros((slots,) + group[0].events.shape, np.float32)
    for i, r in enumerate(group):
        batch[i] = r.events
    return batch


def test_snn_server_groups_equal_their_batch_rows(dev):
    """Six requests in slot groups of 4 (one partial): 2 x T x 3 fused
    launches, and each request's counts, prediction and energies are its
    row of the same padded batch through `run_batch`."""
    from repro_torch.serve import SnnRequest, SnnServer

    sim = _serve_sim(dev, mapping_strategy="greedy")
    srv = SnnServer(sim, batch_slots=4)
    trains = _serve_trains(6)
    reqs = [srv.submit(SnnRequest(uid=i, events=ev, deadline_ms=(
        6e4 if i % 3 == 0 else None))) for i, ev in enumerate(trains)]
    FT.reset_launches()
    done = srv.run()
    torch.cuda.synchronize()
    assert FT.launches == {"fused_timestep_codebook": 2 * 6 * 3,
                           "fused_timestep_dense": 0}
    assert sorted(r.uid for r in done) == list(range(6))
    groups = {}
    for r in done:
        groups.setdefault(r.t_dequeue, []).append(r)
    assert sorted(len(g) for g in groups.values()) == [2, 4]
    for group in groups.values():
        counts, reports = sim.run_batch(torch.as_tensor(
            _slot_batch(group, 4), device=dev))
        counts = counts.cpu().numpy()
        for i, r in enumerate(group):
            np.testing.assert_array_equal(r.spike_counts, counts[i])
            assert r.prediction == int(counts[i].argmax())
            assert (r.energy_pj, r.pj_per_sop) == (reports[i].energy_pj,
                                                   reports[i].pj_per_sop)
    assert all(r.status == "served" for r in reqs)


def test_snn_server_retry_and_degraded_on_the_card(dev):
    from repro_torch.faults import FaultConfig
    from repro_torch.serve import SnnRequest, SnnServer
    from repro_torch.serve.resilience import RetryPolicy

    healthy = _serve_sim(dev, mapping_strategy="greedy")
    trains = _serve_trains(3, seed=4)
    flaky = _serve_sim(dev, mapping=healthy.mapping,
                       faults=FaultConfig(transient_dispatches=(0,)))
    srv = SnnServer(flaky, batch_slots=4, sleep=lambda s: None)
    solo = SnnServer(healthy, batch_slots=4)
    for i, ev in enumerate(trains):
        srv.submit(SnnRequest(uid=i, events=ev))
        solo.submit(SnnRequest(uid=i, events=ev))
    got, want = srv.run(), solo.run()
    assert (srv._m_faults.value, srv._m_retries.value) == (1, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.spike_counts, w.spike_counts)
        assert not g.degraded and g.energy_pj == w.energy_pj
    degraded = _serve_sim(dev, seed=1)
    srv = SnnServer(None, batch_slots=4, dispatch_timeout_s=0.0,
                    retry=RetryPolicy(max_retries=1, base_delay_s=0.0),
                    breaker_threshold=1, sleep=lambda s: None)
    srv.add_model("default", healthy, degraded_sim=degraded)
    reqs = [srv.submit(SnnRequest(uid=i, events=ev))
            for i, ev in enumerate(trains)]
    srv.run()
    counts, _ = degraded.run_batch(torch.as_tensor(_slot_batch(reqs, 4),
                                                   device=dev))
    counts = counts.cpu().numpy()
    assert srv.breakers["default"].state == "open"
    for i, r in enumerate(reqs):
        assert r.degraded
        np.testing.assert_array_equal(r.spike_counts, counts[i])


def test_snn_train_step_on_the_card_matches_the_cpu(dev):
    """One hardware-loss step at 128-48-10, T 6, B 16 from the same
    parameters and batch: loss, rates and the gradient norm within 1e-4
    of the same step on the CPU.  Float weights: a QAT fit of 6144
    weights may settle a level apart under another summation order
    (phase 10 of chip_smoke.py runs QAT at the paper's widths)."""
    from repro_torch.data.synthetic import EventStream
    from repro_torch.models.snn import SNNConfig
    from repro_torch.train import snn_trainer as TR

    ev = EventStream(timesteps=6, height=8, width=8, seed=3)
    cfg = SNNConfig(layer_sizes=(ev.n_inputs, 48, 10), timesteps=6)
    tcfg = TR.SNNTrainConfig(steps=3, hw=TR.HWLossConfig(
        rate_weight=1.0, target_rate=0.08, l1_weight=1e-3))
    out = {}
    for d in ("cpu", dev):
        tr = TR.SNNTrainer(cfg, tcfg, device=d)
        params, opt = tr.init(torch.Generator().manual_seed(6))
        s, l = ev.batch(16, 1, device=d)
        new, opt, m = tr.step(params, opt, s, l)
        out[str(d)] = ({k: float(v) for k, v in m.items()},
                       [p.cpu() for p in new])
        assert all(p.device.type == torch.device(d).type for p in new)
    (mc, pc), (mg, pg) = out["cpu"], out[str(dev)]
    for k in ("loss", "ce", "mean_rate", "grad_norm", "density"):
        assert mg[k] == pytest.approx(mc[k], rel=1e-4), k
    for a, b in zip(pg, pc):
        assert float((a - b).abs().max()) <= 1e-4


def test_fit_per_core_codebooks_on_the_card_matches_the_cpu(dev):
    """Per-core PTQ of one weight set on an anneal mapping (layer 1 over
    17 cores of 3-4 columns, layer 2 over 3): the card's fits are the
    CPU's bit for bit — register words, indexes, codebooks, scales and
    the dequantized weights (the k-means fit is, see below)."""
    from repro_torch.core import soc as SOC
    from repro_torch.core.quant import CodebookConfig
    from repro_torch.deploy import fit_per_core_codebooks
    from repro_torch.models import snn as SNN

    cfg = SNN.SNNConfig(layer_sizes=(128, 64, 10), timesteps=5, qat=True)
    params = SNN.init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    mapping = SOC.map_network(list(cfg.layer_sizes), strategy="anneal")
    for zero_level in (False, True):
        qcfg = CodebookConfig(16, 8, zero_level=zero_level)
        cpu = fit_per_core_codebooks(params, mapping, qcfg)
        card = fit_per_core_codebooks([p.to(dev) for p in params], mapping,
                                      qcfg)
        assert [t.codebook_words for t in card.tables] == \
            [t.codebook_words for t in cpu.tables]
        for key, q in cpu.slices.items():
            g = card.slices[key]
            assert g.idx.device.type == "cuda"
            assert torch.equal(g.idx.cpu(), q.idx), key
            assert torch.equal(g.codebook.cpu(), q.codebook), key
            assert torch.equal(g.scale.cpu(), q.scale), key
        for a, b in zip(card.weights, cpu.weights):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("shape,group_size", [((2312, 64), 0),
                                              ((300, 96), 16),
                                              ((4096, 33), 0)])
@pytest.mark.parametrize("bit_width", [4, 8, 16])
def test_quantize_on_the_card_is_bitwise_the_cpu(dev, shape, group_size,
                                                  bit_width):
    """A k-means fit on the card equals the CPU's bit for bit: cluster
    sums by a tree fixed by the size, true divisions only (the card
    divides by a host scalar through its reciprocal)."""
    from repro_torch.core.quant import CodebookConfig, quantize

    rng = np.random.default_rng(sum(shape) + bit_width)
    w = torch.tensor(rng.normal(0, 0.05, shape).astype(np.float32))
    for zero_level in (False, True):
        cfg = CodebookConfig(16, bit_width, group_size=group_size,
                             zero_level=zero_level)
        cpu, card = quantize(w, cfg), quantize(w.to(dev), cfg)
        for a, b in zip(card[:3], cpu[:3]):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


def _board(dev, engine, quantized=False, sizes=(64, 120, 96, 56, 16)):
    """A network over two fullerene domains (8 neurons a core), the
    fixture of tests/test_sharded_engine.py, on `dev`."""
    from repro_torch import ChipSimulator, CodebookConfig
    from repro_torch.compiler import ChipSpec, compile_network

    rng = np.random.default_rng(1)
    ws = [rng.normal(0, 0.5, (a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    cn = compile_network(ws, ChipSpec(neurons_per_core=8, max_domains=4),
                         seed=3)
    assert cn.n_domains_used >= 2
    return ChipSimulator(ws, mapping=cn.to_soc_mapping(), engine=engine,
                         quant_cfg=CodebookConfig(16, 8) if quantized
                         else None, device=dev)


def _board_trains(dev, batch=8, steps=10, n_in=64):
    rng = np.random.default_rng(2)
    return torch.tensor((rng.random((batch, steps, n_in)) < 0.25)
                        .astype(np.float32), device=dev)


def _same_run(got, want):
    (ys_g, c_g), (ys_w, c_w) = got, want
    assert set(ys_g) == set(ys_w)
    for k in ys_w:
        assert torch.equal(ys_g[k], ys_w[k]), k
    assert torch.equal(c_g, c_w)


def test_sharded_engine_one_shard_on_the_card_is_bitwise_compiled(dev):
    """S = 1 holds the whole matrix in the compiled engine's column
    order, so on the card too its counters are the compiled engine's."""
    trains = _board_trains(dev)
    comp, shrd = _board(dev, "compiled"), _board(dev, "sharded")
    eng = shrd.array_engine()
    assert eng.n_shards == 1 and eng.n_domains >= 2
    _same_run(eng.run_raw(trains), comp.array_engine().run_raw(trains))
    assert not eng.last_run_sharded and eng.last_exchange_bytes == 0


def test_nccl_world_one_runs_the_exchange_code(dev, tmp_path):
    """One NCCL process at world size 1: the sharded engine's word
    exchange and counter sums and the fused engine's batch gather run
    through the collectives and change nothing."""
    import datetime

    import torch.distributed as dist

    trains = _board_trains(dev)
    want_s = _board(dev, "compiled").array_engine().run_raw(trains)
    want_f = _board(dev, "fused", quantized=True).array_engine().run_raw(
        trains)
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        shrd = _board(dev, "sharded").array_engine()
        ys, counts = got = shrd.run_raw(trains)
        _same_run(got, want_s)
        # the spike words of every layer-step, then the batch gather
        words = sum(sl.words for sl in shrd.sharded_layers)
        rows = sum(t.numel() * t.element_size()
                   for t in [*ys.values(), counts])
        assert shrd.last_exchange_bytes == 2 * words * 8 * 10 + rows
        fused = _board(dev, "fused", quantized=True).array_engine()
        FT.reset_launches()
        _same_run(fused.run_raw(trains), want_f)
        assert FT.launches["fused_timestep_codebook"] == 10 * 4
        assert fused.last_exchange_bytes > 0
        assert not fused.last_run_sharded      # one rank splits nothing
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# C3 codebook-quantized LM serving and the moe family on the card

# granite-moe-1b-a400m's decode products (M = 4 rows, the server's slots):
# wq / wo (1024 x 1024), wk / wv (1024 x 512), the router (1024 x 32)
DECODE_SHAPES = [(4, 1024, 1024), (4, 1024, 512), (4, 1024, 32)]


@pytest.mark.parametrize("m,k,n", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_linear_on_a_codebook_weight_launches_the_kernel(dev, m, k, n,
                                                         dtype):
    """`linear` on a CodebookWeight: one codebook_matmul launch, against
    the plain product in f64 (the kernel sums in f64, rounds once to f32,
    then to x's type)."""
    from repro_torch.kernels import codebook_matmul as CBM
    from repro_torch.models.common import CodebookWeight, linear

    rng = np.random.default_rng(m + k + n)
    x = torch.tensor(rng.normal(0, 1, (1, m, k)).astype(np.float32),
                     device=dev).to(dtype)
    idx = torch.tensor(rng.integers(0, 16, (k, n)).astype(np.int8),
                       device=dev)
    cb = torch.tensor(np.sort(rng.normal(0, 0.05, 16)).astype(np.float32),
                      device=dev).to(torch.bfloat16).float()
    CBM.reset_launches()
    out = linear(x, CodebookWeight(idx, cb))
    torch.cuda.synchronize()
    assert CBM.launches["codebook_matmul"] == 1
    assert out.dtype == dtype and out.shape == (1, m, n)
    want = (x.double().reshape(m, k) @ cb.double()[idx.long()]).float()
    if dtype == torch.float32:
        torch.testing.assert_close(out.reshape(m, n), want, atol=V_ATOL,
                                   rtol=V_RTOL)
    else:
        torch.testing.assert_close(out.reshape(m, n), want.to(dtype))


def _tiny_cfg(family, **kw):
    from repro_torch.models.common import ArchConfig

    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=97, dtype=torch.float32)
    base.update(kw)
    return ArchConfig(f"{family}-t", family, **base)


def test_moe_ffn_on_the_card_matches_the_cpu(dev):
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    cfg = _tiny_cfg("moe", n_kv_heads=4, d_ff=32, n_experts=4, top_k=2,
                    moe_group_size=32)
    model = T.init_model(cfg, torch.Generator().manual_seed(0))
    x = torch.tensor(np.random.default_rng(5).normal(0, 1, (4, 64, 64))
                     .astype(np.float32))
    lp = model.blocks[0].leaves()
    want, want_aux = MOE.moe_ffn(x, lp, cfg)
    got, aux = MOE.moe_ffn(x.to(dev), {k: v.detach().to(dev)
                                       for k, v in lp.items()}, cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want.detach(), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux.detach(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("family,kw,per_layer", [
    ("dense", dict(d_model=256, n_kv_heads=2, d_ff=256), 7),
    ("moe", dict(d_model=256, n_kv_heads=2, d_ff=16, n_experts=128,
                 top_k=2, moe_group_size=32), 5)], ids=["dense", "moe"])
def test_quantized_4bit_route_on_the_card_matches_the_cpu(dev, family, kw,
                                                           per_layer):
    """4-bit C3 weights fitted on the CPU, the model copied to the card: a
    256-token prefill and two decode steps give the CPU's logits within
    1e-4, with one codebook_matmul launch per 2-D projection and layer."""
    from repro_torch.core.quant import CodebookConfig
    from repro_torch.kernels import codebook_matmul as CBM
    from repro_torch.models import transformer as T
    from repro_torch.quant import lm_quant as Q

    cfg = _tiny_cfg(family, **kw)
    model = T.init_model(cfg, torch.Generator().manual_seed(0))
    qcpu = Q.quantize_blocks(model, CodebookConfig(16, 8, kmeans_iters=4),
                             pack_4bit=True)
    qdev = T.Transformer(cfg, *(t.detach().to(dev) for t in (
        qcpu.embed, qcpu.unembed, qcpu.final_norm)), [
        {k: ({n: b.to(dev) for n, b in v.items()} if isinstance(v, dict)
             else v.detach().to(dev)) for k, v in blk.leaves().items()}
        for blk in qcpu.blocks])
    pt = Q.make_param_transform(torch.float32)
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 258)).astype(np.int32))
    logits = []
    for m, t in ((qcpu, toks), (qdev, toks.to(dev))):
        CBM.reset_launches()
        out, st = T.forward_prefill(m, cfg, {"tokens": t[:, :256]}, 264,
                                    param_transform=pt)
        outs = [out]
        for i in (256, 257):
            out, st = T.forward_decode(m, cfg, st, t[:, i:i + 1],
                                       param_transform=pt)
            outs.append(out)
        logits.append(torch.stack(outs).cpu())
    torch.cuda.synchronize()
    assert CBM.launches["codebook_matmul"] == 3 * per_layer * cfg.n_layers
    torch.testing.assert_close(logits[1], logits[0], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the ssm and audio families on the card


def test_mamba2_layer_on_the_card_matches_the_cpu(dev):
    """One mamba2 layer in f32 (A_log, D, dt_bias drawn at random): a
    40-token forward (padded to three chunks of 16) with its cache, then
    three decode steps, on the card against the CPU within 1e-4."""
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import transformer as T

    cfg = _tiny_cfg("ssm", n_heads=0, n_kv_heads=0, d_ff=0, ssm_state=16,
                    ssm_head_dim=32, ssm_chunk=16)
    model = T.init_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    lp = {k: v.detach() for k, v in model.blocks[0].leaves().items()}
    nh = M2.dims(cfg)[1]
    for name, scale in (("A_log", 0.5), ("D", 1.0), ("dt_bias", 0.5)):
        lp[name] = torch.tensor(rng.normal(0, scale, nh).astype(np.float32))
    on_dev = {k: v.to(dev) for k, v in lp.items()}
    x = torch.tensor(rng.normal(0, 1, (2, 40, 64)).astype(np.float32))
    want, wc = M2.mamba2_forward(x, lp, cfg, return_cache=True)
    got, gc = M2.mamba2_forward(x.to(dev), on_dev, cfg, return_cache=True)
    for step in range(4):
        torch.cuda.synchronize()
        for g, w in ((got, want), (gc.conv, wc.conv), (gc.state, wc.state)):
            torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)
        if step == 3:
            break
        xs = torch.tensor(rng.normal(0, 1, (2, 1, 64)).astype(np.float32))
        want, wc = M2.mamba2_decode(xs, lp, cfg, wc)
        got, gc = M2.mamba2_decode(xs.to(dev), on_dev, cfg, gc)


def test_whisper_prefill_takes_the_flash_kernel(dev):
    """whisper-tiny's widths (d 384, 6 heads of hd 64, bf16), depth cut
    to 2 decoder and 1 encoder layers over 64 zero frames: a 256-token
    prefill launches the tensor-core flash kernel once per decoder layer
    (the encoder and cross-attention never), each call within 2e-2 of the
    plain version on its q / k / v, the logits and one decode step's
    within 0.125 of the same model on the CPU."""
    import copy

    from repro_torch.configs import registry as R
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as ATT
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(R.get_arch("whisper-tiny"), n_layers=2,
                              enc_layers=1, enc_frames=64, vocab=1000)
    model = T.init_model(cfg, torch.Generator().manual_seed(0))
    on_dev = copy.deepcopy(model).to(dev)
    toks = torch.tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 257)).astype(np.int32))
    frames = torch.zeros((2, cfg.enc_frames, cfg.d_model))
    flash = ATT.flash_attention
    errs = []

    def checked(q, k, v, *, causal=True):
        out = flash(q, k, v, causal=causal)
        errs.append(float((out.float() - FA.flash_attention_plain(
            q, k, v, causal).float()).abs().max()))
        return out

    logits = []
    for m, d in ((model, "cpu"), (on_dev, dev)):
        batch = {"tokens": toks[:, :256].to(d), "frames": frames.to(d)}
        FA.reset_launches()
        ATT.flash_attention = checked
        try:
            out, st = T.forward_prefill(m, cfg, batch, 264)
        finally:
            ATT.flash_attention = flash
        step, _ = T.forward_decode(m, cfg, st, toks[:, 256:].to(d))
        torch.cuda.synchronize()
        logits.append(torch.stack([out, step]).float().cpu())
    assert FA.launches == {"flash_attention": 2, "flash_attention_wgmma": 2}
    assert len(errs) == 4 and max(errs[2:]) <= 2e-2
    assert bool(logits[1].isfinite().all())
    torch.testing.assert_close(logits[1], logits[0], atol=0.125, rtol=0)


# ---------------------------------------------------------------------------
# the vlm family and LM training on the card


def test_vlm_prefill_at_hd96_on_the_card_matches_the_cpu(dev):
    """phi-3-vision's head dim (96) and 576 patches, depth cut to 2
    layers and d to 384 (4 heads), f32: patches + a 64-token prompt are
    640 positions, which take the SIMT flash kernel once per layer (the
    route used to raise there); logits and caches within the LM
    tolerance (1e-4) of the same model on the CPU, and one decode step
    after it."""
    import copy

    from repro_torch.configs import registry as R
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(R.get_arch("phi-3-vision-4.2b"), n_layers=2,
                              d_model=384, n_heads=4, n_kv_heads=4,
                              d_ff=512, vocab=512, dtype=torch.float32)
    assert cfg.hd == 96
    model = T.init_model(cfg, torch.Generator().manual_seed(0))
    on_dev = copy.deepcopy(model).to(dev)
    rng = np.random.default_rng(8)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (2, 65)).astype(np.int32))
    patches = torch.tensor(rng.normal(0, 1, (2, 576, 384)).astype(
        np.float32))
    out = []
    for m, d in ((model, "cpu"), (on_dev, dev)):
        FA.reset_launches()
        batch = {"tokens": toks[:, :64].to(d), "patch_embeds": patches.to(d)}
        logits, st = T.forward_prefill(m, cfg, batch, 704)
        step, st = T.forward_decode(m, cfg, st, toks[:, 64:].to(d))
        torch.cuda.synchronize()
        out.append((logits.cpu(), step.cpu(), st.kv.k.cpu(), st.kv.v.cpu()))
        assert int(st.pos) == 641
    assert FA.launches == {"flash_attention": 2, "flash_attention_wgmma": 0}
    for got, want in zip(out[1], out[0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_vlm_bf16_prefill_takes_the_tensor_core_kernel(dev):
    """bf16 at hd 96 runs the tensor-core kernel once per layer at 640
    positions, and a 512-token prompt (1088 positions, not a multiple of
    128) takes the plain SDPA."""
    from repro_torch.configs import registry as R
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(R.get_arch("phi-3-vision-4.2b"), n_layers=2,
                              d_model=384, n_heads=4, n_kv_heads=4,
                              d_ff=512, vocab=512)
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    for prompt, launches in ((64, 2), (512, 0)):
        batch = {"tokens": torch.zeros((2, prompt), dtype=torch.int32,
                                       device=dev),
                 "patch_embeds": torch.zeros((2, 576, 384), device=dev)}
        FA.reset_launches()
        logits, _ = T.forward_prefill(model, cfg, batch, 1100)
        torch.cuda.synchronize()
        assert FA.launches == {"flash_attention": launches,
                               "flash_attention_wgmma": launches}
        assert bool(logits.float().isfinite().all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_backward_on_the_card(dev, dtype):
    """The flash route's autograd.Function on the card: one kernel launch
    forward, none backward, and q / k / v gradients equal to autograd of
    the plain version on the card (the same function, recomputed); in
    f32 also within 1e-4 of the largest gradient of the CPU's."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as ATT

    q, k, v = _flash_inputs(dev, 5, 2, 8, 2, 256, 256, 64, dtype)
    g = _flash_inputs(dev, 6, 2, 8, 8, 256, 256, 64, dtype)[0]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.reset_launches()
    out = ATT._FlashCore.apply(*leaves)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention"] == 1
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert FA.launches["flash_attention"] == 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(FA.flash_attention_plain(*plain), plain, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if dtype == torch.float32:
        cpu = [t.cpu().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(FA.flash_attention_plain(*cpu), cpu,
                                  g.cpu())
        for a, b in zip(got, ref):
            torch.testing.assert_close(a.cpu(), b, rtol=0,
                                       atol=1e-4 * float(b.abs().max()))


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One `make_train_step` of granite-3-2b's SMOKE model in f32 at
    S = 256 (the flash route: two launches per layer, the forward and
    its recompute under the remat default "nothing", none in the
    backward proper), on the card and on the CPU from the same weights:
    loss and grad_norm within 1e-5 relative, the moments within 1e-4 of
    each leaf's largest."""
    import copy

    from repro_torch.configs import registry as R
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(R.get_arch("granite-3-2b", smoke=True),
                              dtype=torch.float32)
    model = T.init_model(cfg, torch.Generator().manual_seed(0))
    step = make_train_step(cfg, adamw.AdamWConfig(warmup_steps=10))
    data = TokenStream(cfg.vocab, 256, 2, seed=3)
    out = []
    for m, d in ((model, "cpu"), (copy.deepcopy(model).to(dev), dev)):
        FA.reset_launches()
        _, opt, metrics = step(m, adamw.init(dict(m.named_parameters())),
                               data.batch_at(0, d))
        torch.cuda.synchronize()
        out.append((metrics, opt))
        assert FA.launches["flash_attention"] == (
            2 * cfg.n_layers if d == dev else 0)
    (cm, copt), (gm, gopt) = out
    for key in ("loss", "grad_norm"):
        assert abs(float(gm[key]) - float(cm[key])) <= 1e-5 * abs(
            float(cm[key])), key
    for name, want in copt.m.items():
        torch.testing.assert_close(gopt.m[name].cpu(), want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def test_tensor_parallel_step_on_two_gloo_ranks_matches_cpu(dev, tmp_path):
    """granite-3-2b's widths at 4 layers, f32, B 2 x S 256 (the flash
    route): one `make_train_step(mesh=...)` step on two gloo ranks of a
    data 1 x model 2 mesh, both on the card, against the one-device step
    on the CPU: loss within 1e-4 and grad_norm within 1e-3 (relative;
    another summation order on the card)."""
    import sys
    from pathlib import Path

    from repro_torch.configs import registry as R
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    sys.path.insert(0, str(Path(__file__).parent))
    from torch_mesh_ranks import spawn_mesh_ranks

    cfg = dataclasses.replace(R.get_arch("granite-3-2b"), n_layers=4,
                              dtype=torch.float32)
    model = T.init_model(cfg, torch.Generator().manual_seed(0))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 257), generator=gen)
    batch = {"tokens": toks[:, :-1].to(torch.int32),
             "labels": toks[:, 1:].to(torch.int32)}
    opt_kw = dict(warmup_steps=10, total_steps=100)
    opt = adamw.init(dict(model.named_parameters()))
    _, _, want = ST.make_train_step(cfg, adamw.AdamWConfig(**opt_kw))(
        model, opt, batch)
    case = dict(kind="train", arch="granite-3-2b", params=params,
                batches=[batch], opt=opt_kw,
                smoke=False, cfg=dict(n_layers=4))
    ranks = spawn_mesh_ranks(tmp_path, 2, 2, [case], device="cuda:0")
    for (r,) in ranks:
        assert abs(r["loss"][0] - float(want["loss"])) <= 1e-4 * abs(
            float(want["loss"]))
        assert abs(r["grad_norm"][0] - float(want["grad_norm"])) <= 1e-3 \
            * float(want["grad_norm"])


# ---------------------------------------------------------------------------
# C3 products on a DeviceMesh: the codebook kernel on each rank's shards


@pytest.fixture
def nccl_mesh(dev):
    """A data 1 x model 1 mesh over one NCCL rank (`make_host_mesh` starts
    the world of one), torn down after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    mesh = make_host_mesh(device=dev)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "4bit"])
@pytest.mark.parametrize("split", ["n", "k"])
def test_c3_linear_on_dtensors_launches_on_the_shard(nccl_mesh, packed,
                                                     split):
    """`linear` on DTensor operands (x, and a CodebookWeight whose idx is
    laid out column- or row-parallel on "model") launches the codebook
    kernel once, on plain local tensors, and gives the one-device
    product: bitwise on this mesh of one device."""
    from repro_torch.core.quant import pack_indexes_4bit
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import codebook_matmul as CBM
    from repro_torch.models.common import CodebookWeight, linear

    mesh = nccl_mesh
    dev = torch.device("cuda")
    rng = np.random.default_rng(41)
    m, k, n = 4, 256, 128
    x = torch.tensor(rng.normal(0, 1, (1, m, k)).astype(np.float32),
                     device=dev).to(torch.bfloat16)
    idx = torch.tensor(rng.integers(0, 16, (k, n)).astype(np.int8),
                       device=dev)
    cb = torch.tensor(np.sort(rng.normal(0, 0.05, 16)).astype(np.float32),
                      device=dev).to(torch.bfloat16).float()
    want = linear(x, CodebookWeight(idx, cb))
    ix = pack_indexes_4bit(idx) if packed else idx
    spec = SH.P(None, "model") if split == "n" else SH.P("model", None)
    xd = SH.shard(x, SH.P("data", None, "model" if split == "k" else None),
                  mesh)
    w = CodebookWeight(SH.shard(ix, spec, mesh), SH.replicated(cb, mesh))
    if packed:
        w = w._replace(packed=True)
    kernel, seen = CBM.codebook_matmul, []

    def spy(a, b, c):
        seen.append(any(SH.is_dtensor(t) for t in (a, b, c)))
        return kernel(a, b, c)

    CBM.reset_launches()
    CBM.codebook_matmul = spy
    try:
        got = linear(xd, w)
    finally:
        CBM.codebook_matmul = kernel
    torch.cuda.synchronize()
    assert seen == [False] and CBM.launches["codebook_matmul"] == 1
    assert SH.is_dtensor(got) and got.dtype == torch.bfloat16
    assert torch.equal(got.full_tensor(), want)


def test_meshed_c3_prefill_on_one_nccl_rank_matches_one_device(nccl_mesh):
    """A C3 int8 model (f32, granite-3-2b's head dim, MLP quantized):
    `Server(mesh=...)`'s prefill on a 1 x 1 NCCL mesh against the
    one-device server's, the same logits and the same codebook launches
    (3 MLP products x 2 layers)."""
    from repro_torch.kernels import codebook_matmul as CBM
    from repro_torch.models import transformer as T
    from repro_torch.quant import lm_quant as Q
    from repro_torch.serve.server import Server

    dev = torch.device("cuda")
    cfg = dataclasses.replace(_tiny_cfg("dense", d_model=128, n_kv_heads=4,
                                        d_ff=512), quant_serving=True)
    batch = {"tokens": torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32), device=dev)}
    out = []
    for mesh in (None, nccl_mesh):
        model = Q.quantize_blocks(T.init_model(
            cfg, torch.Generator(device=dev).manual_seed(0)))
        srv = Server(cfg, model, batch_slots=2, cache_len=32, mesh=mesh)
        CBM.reset_launches()
        logits, _ = srv.prefill(srv.params, batch=batch)
        torch.cuda.synchronize()
        out.append((logits.full_tensor() if mesh else logits,
                    CBM.launches["codebook_matmul"]))
    assert out[0][1] == out[1][1] == 3 * cfg.n_layers
    torch.testing.assert_close(out[1][0], out[0][0], atol=1e-5, rtol=1e-5)
