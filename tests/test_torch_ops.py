"""The port's kernel API (`repro_torch.kernels.ops`) against the
reference's (`repro.kernels.ops`, Pallas in interpret mode), on the CPU
where the port runs each kernel's plain version: the same numpy inputs
through both.  Plus the plain oracles of `kernels/ref.py` against the
reference's, and the README's quickstart flow through both packages."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import quant as REF_Q  # noqa: E402
from repro.core import zspe as REF_Z  # noqa: E402
from repro.kernels import ops as REF_OPS  # noqa: E402
from repro.kernels import ref as REF_REF  # noqa: E402
from repro.kernels import zspe_spmm as REF_ZSPE  # noqa: E402
from test_torch_harness import (assert_step_close, c_argtypes,  # noqa: E402
                                launch_args)

from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.core import zspe as Z  # noqa: E402
from repro_torch.kernels import codebook_matmul as CBM  # noqa: E402
from repro_torch.kernels import lif_update as LU  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import zspe_spmm as ZS  # noqa: E402


def _codebook_case(seed, m, k, n, levels, lead=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k) if lead is None else (*lead, k))
    idx = rng.integers(0, levels, (k, n)).astype(np.int8)
    cb = np.sort(rng.normal(0, 1, levels)).astype(np.float32)
    return x.astype(np.float32), idx, cb


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# codebook matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,levels", [(1, 1, 1, 4), (37, 200, 180, 8),
                                          (150, 65, 3, 16)])
def test_codebook_matmul_matches_reference(m, k, n, levels):
    x, idx, cb = _codebook_case(m + k + n, m, k, n, levels)
    want = REF_OPS.codebook_matmul(jnp.asarray(x), jnp.asarray(idx),
                                   jnp.asarray(cb))
    got = ops.codebook_matmul(_t(x), _t(idx), _t(cb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * k)


def test_codebook_matmul_batched_and_bf16_x():
    x, idx, cb = _codebook_case(0, 0, 64, 96, 16, lead=(2, 3))
    want = REF_OPS.codebook_matmul(jnp.asarray(x), jnp.asarray(idx),
                                   jnp.asarray(cb))
    got = ops.codebook_matmul(_t(x), _t(idx), _t(cb))
    assert got.shape == (2, 3, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * 64)
    # bf16 x is widened exactly, so only the summation order differs
    xb, idx, cb = _codebook_case(1, 16, 128, 128, 8)
    xb = torch.as_tensor(xb).to(torch.bfloat16)
    want = REF_OPS.codebook_matmul(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(idx), jnp.asarray(cb))
    got = ops.codebook_matmul(xb, _t(idx), _t(cb))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * 128)


def test_codebook_matmul_grads_match_reference():
    x, idx, cb = _codebook_case(2, 32, 48, 40, 16)
    g_ref = jax.grad(
        lambda a, c: jnp.sum(REF_OPS.codebook_matmul(a, jnp.asarray(idx), c)
                             ** 2), argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.asarray(cb))
    xt = _t(x).requires_grad_()
    cbt = _t(cb).requires_grad_()
    (ops.codebook_matmul(xt, _t(idx), cbt) ** 2).sum().backward()
    for got, want in zip((xt.grad, cbt.grad), g_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-2)


@pytest.mark.parametrize("lo,hi,levels", [(-3, 11, 8), (-20, 21, 16)])
def test_codebook_matmul_grads_match_reference_out_of_range(lo, hi, levels):
    """Indexes outside [0, L): the forward gives 0 there (the Pallas
    kernel's compare-and-select), but the reference's backward gathers
    `codebook[idx]` (a negative index wraps by +L, then clamps), so gx
    must gather the same way; gcb skips such positions in both."""
    rng = np.random.default_rng(levels)
    x = rng.normal(0, 1, (8, 16)).astype(np.float32)
    idx = rng.integers(lo, hi, (16, 16)).astype(np.int8)
    cb = np.sort(rng.normal(0, 1, levels)).astype(np.float32)
    assert ((idx < 0) | (idx >= levels)).any() and (idx < 0).any()
    g_ref = jax.grad(
        lambda a, c: jnp.sum(REF_OPS.codebook_matmul(
            a, jnp.asarray(idx), c, interpret=True) ** 2),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(cb))
    xt = _t(x).requires_grad_()
    cbt = _t(cb).requires_grad_()
    (ops.codebook_matmul(xt, _t(idx), cbt) ** 2).sum().backward()
    for got, want in zip((xt.grad, cbt.grad), g_ref):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_codebook_out_of_range_index_contributes_zero():
    x = torch.ones(2, 3)
    idx = torch.tensor([[0], [-1], [4]], dtype=torch.int8)
    cb = torch.tensor([1.0, 2.0, 3.0, 4.0])
    np.testing.assert_array_equal(ops.codebook_matmul(x, idx, cb).numpy(),
                                  [[1.0], [1.0]])
    with pytest.raises(ValueError, match="16 levels"):
        ops.codebook_matmul(x, idx, torch.zeros(17))
    with pytest.raises(TypeError, match="idx must be torch.int8"):
        ops.codebook_matmul(x, idx.long(), cb)


def test_codebook_out_of_range_matches_reference():
    """Indexes outside [0, L) (negative bytes, and 8..20 with L = 8)
    contribute 0 in both packages: the reference's compare-and-select and
    the port's lookup table (zero past L)."""
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (9, 70)).astype(np.float32)
    idx = rng.integers(-20, 21, (70, 33)).astype(np.int8)
    idx[0, :2] = (16, -128)
    cb = np.sort(rng.normal(0, 1, 8)).astype(np.float32)
    want = REF_OPS.codebook_matmul(jnp.asarray(x), jnp.asarray(idx),
                                   jnp.asarray(cb))
    got = ops.codebook_matmul(_t(x), _t(idx), _t(cb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# the codebook kernel's launch plan (kernels/codebook_matmul.py `_plan`) at
# the paper's network (configs/snn_chip.py ARCH, 2312-4096-1024-10)
ARCH_LAYERS = [(2312, 4096), (4096, 1024), (1024, 10)]


def _blocks(m, n, plan):
    return -(-m // plan.bm) * -(-n // CBM.BN) * plan.split


def _k_ranges(k, plan):
    """The rows of K each block of a cluster sums, as the kernel cuts them
    (`k0 = rank * k_chunk`, `k_end = min(K, k0 + k_chunk)`)."""
    return [(min(k, r * plan.k_chunk), min(k, (r + 1) * plan.k_chunk))
            for r in range(plan.split)]


def _coverage(k, plan):
    seen = np.zeros(k, np.int64)
    for lo, hi in _k_ranges(k, plan):
        seen[lo:hi] += 1
    return seen


@pytest.mark.parametrize("m", [32, 200, 640])
@pytest.mark.parametrize("k,n", ARCH_LAYERS)
def test_codebook_plan_at_arch_layers(m, k, n):
    plan = CBM._plan(m, k, n)
    assert 1 <= plan.split <= CBM.MAX_SPLIT == 8     # one cluster
    assert plan.bm == (32 if m <= 32 else 64)
    assert plan.k_chunk % CBM.STAGE_K == 0
    assert plan.split * plan.k_chunk >= k
    assert (_coverage(k, plan) == 1).all()           # every row once


def test_codebook_plan_fills_the_card_at_one_step():
    """At M = 32 (one step of the kernel-API path) layers 1 and 2 launch
    at least 128 blocks, and the 10-wide layer 3 is no longer one block."""
    for k, n in ARCH_LAYERS[:2]:
        assert _blocks(32, n, CBM._plan(32, k, n)) >= 128
    k, n = ARCH_LAYERS[2]
    assert _blocks(32, n, CBM._plan(32, k, n)) > 1


@pytest.mark.parametrize("k", [0, 1, 31, 33, 999, 2312, 4100])
@pytest.mark.parametrize("m,n", [(32, 10), (32, 1024), (640, 4096)])
def test_codebook_k_ranges_cover_every_row_once(k, m, n):
    """K = 2312 is no multiple of 16 x split, K = 1 has one row: each row
    of K is summed by exactly one block of the cluster."""
    plan = CBM._plan(m, k, n)
    assert (_coverage(k, plan) == 1).all()
    assert all(lo <= hi for lo, hi in _k_ranges(k, plan))


# the zspe kernel's launch plan (kernels/zspe_spmm.py `_plan`)

def _zspe_blocks(m, n, plan):
    return -(-m // ZS.BM) * -(-n // ZS.BN) * plan.split


@pytest.mark.parametrize("m", [32, 640])
@pytest.mark.parametrize("k,n", ARCH_LAYERS)
def test_zspe_plan_at_arch_layers(m, k, n):
    plan = ZS._plan(m, k, n)
    assert (ZS.BM, ZS.BN) == (32, 64)
    assert 1 <= plan.split <= ZS.MAX_SPLIT == 8       # one cluster
    assert plan.split & (plan.split - 1) == 0
    assert plan.k_chunk % ZS.K_GROUP == 0
    assert plan.split * plan.k_chunk >= k
    assert (_coverage(k, plan) == 1).all()            # every row once
    # the smallest split that reaches the target grid
    if plan.split > 1:
        half = plan._replace(split=plan.split // 2)
        assert _zspe_blocks(m, n, half) < ZS.TARGET_BLOCKS


def test_zspe_plan_fills_the_card_at_one_step():
    """At M = 32 (one step of the kernel-API path) layers 1 and 2 launch
    about one block per SM (the H100 has 132), and the 10-wide layer 3 is
    no longer one block."""
    for k, n in ARCH_LAYERS[:2]:
        assert 100 <= _zspe_blocks(32, n, ZS._plan(32, k, n)) <= 264
    assert ZS._plan(32, 2312, 4096).split == 2
    assert ZS._plan(32, 4096, 1024).split == 8
    k, n = ARCH_LAYERS[2]
    assert _zspe_blocks(32, n, ZS._plan(32, k, n)) > 1


@pytest.mark.parametrize("k", [0, 1, 31, 33, 999, 1025, 2312, 4100, 32768])
@pytest.mark.parametrize("m,n", [(1, 10), (32, 37), (32, 1024), (200, 10),
                                 (640, 4096)])
def test_zspe_k_ranges_cover_every_row_once(k, m, n):
    """K that no split divides (K = 1, 999, 2312, ...): each row of K is
    summed by exactly one block of the cluster, and a slice is a multiple
    of the kernel's 32-k groups."""
    plan = ZS._plan(m, k, n)
    assert (_coverage(k, plan) == 1).all()
    assert all(lo <= hi for lo, hi in _k_ranges(k, plan))
    assert plan.k_chunk % ZS.K_GROUP == 0 and plan.k_chunk > 0


# ---------------------------------------------------------------------------
# zspe spmm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,density", [(100, 300, 50, 0.02),
                                           (1, 1, 1, 1.0),
                                           (64, 256, 160, 0.0)])
def test_zspe_spmm_matches_reference(m, k, n, density):
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    s = (rng.random((m, k)) < density).astype(np.float32)
    w = rng.normal(0, 1, (k, n)).astype(np.float32)
    want, want_skip = REF_OPS.zspe_spmm(jnp.asarray(s), jnp.asarray(w),
                                        with_stats=True)
    got, skip = ops.zspe_spmm(_t(s), _t(w), with_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * k)
    np.testing.assert_array_equal(skip.numpy(), np.asarray(want_skip))


def test_zspe_skip_counters_match_popcount_golden():
    """The tile-structured golden case: about half the (64, 64) spike
    tiles hold a few spikes; counters equal the reference kernel's at the
    same block and an exact numpy popcount."""
    rng = np.random.default_rng(0)
    m, k, n = 128, 256, 128
    bm, bk, bn = 64, 64, 64
    s = np.zeros((m, k), np.float32)
    for i in range(m // bm):
        for kk in range(k // bk):
            if rng.random() < 0.5:
                s[i * bm + rng.integers(0, bm, 5),
                  kk * bk + rng.integers(0, bk, 5)] = 1.0
    w = rng.normal(0, 1, (k, n)).astype(np.float32)
    want, want_skip = REF_ZSPE.zspe_spmm(jnp.asarray(s), jnp.asarray(w),
                                         block=(bm, bk, bn), interpret=True)
    got, skip = ZS.zspe_spmm(_t(s), _t(w), block=(bm, bk, bn))
    expected = np.zeros((m // bm, n // bn), np.int32)
    for i in range(m // bm):
        for kk in range(k // bk):
            expected[i] += not s[i * bm:(i + 1) * bm,
                                 kk * bk:(kk + 1) * bk].any()
    assert 0 < expected.sum() < expected.size * (k // bk)
    np.testing.assert_array_equal(np.asarray(want_skip), expected)
    np.testing.assert_array_equal(skip.numpy(), expected)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_zspe_int8_spikes_and_leading_dims():
    rng = np.random.default_rng(3)
    s = (rng.random((2, 32, 128)) < 0.1).astype(np.int8)
    w = rng.normal(0, 1, (128, 64)).astype(np.float32)
    want, want_skip = REF_OPS.zspe_spmm(jnp.asarray(s), jnp.asarray(w),
                                        with_stats=True)
    got, skip = ops.zspe_spmm(_t(s), _t(w), with_stats=True)
    assert got.shape == (2, 32, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_array_equal(skip.numpy(), np.asarray(want_skip))


# ---------------------------------------------------------------------------
# fused LIF update
# ---------------------------------------------------------------------------

def _lif_case(seed, shape):
    rng = np.random.default_rng(seed)
    v = rng.normal(0.3, 0.6, shape).astype(np.float32)
    el = rng.integers(0, 6, shape).astype(np.int32)
    cur = np.where(rng.random(shape) < 0.4, rng.normal(0, 1.5, shape),
                   0.0).astype(np.float32)
    cur[rng.random(shape) < 0.1] = -0.0          # no input, like +0.0
    return v, el, cur


def _assert_lif_close(got, want, v, el, cur, leak):
    """elapsed', spikes, updated exact; v' within the one-ulp rule of the
    LIF step (ROADMAP Queue 3): equal where there is no input, else within
    one ulp of v * decay plus one of v' (`leak ** pending` may differ by
    an ulp, and the reference's jitted kernel may contract v * decay +
    current into one FMA where the port rounds twice)."""
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3].astype(np.int8),
                                  want[3].astype(np.int8))
    pend = (el + 1).astype(np.float32)
    ref_decay = np.asarray(jnp.float32(leak) ** jnp.asarray(pend))
    v_int = v * ref_decay + cur
    same = got[2] == want[2]
    assert (same | (np.abs(v_int - 1.0) < 1e-6)).all()
    idle = same & (cur == 0)
    np.testing.assert_array_equal(got[0][idle], want[0][idle])
    fed = same & (cur != 0)
    assert (np.abs(got[0] - want[0])[fed]
            <= (np.spacing(np.abs(v * ref_decay))
                + np.spacing(np.abs(want[0])))[fed]).all()


@pytest.mark.parametrize("shape", [(5, 300), (2, 3, 40), (1, 37), (3, 37)])
def test_lif_update_matches_reference(shape):
    """Gaussian currents with +0.0 and -0.0 among them (no input); the
    last two element counts are not a multiple of four."""
    v, el, cur = _lif_case(sum(shape), shape)
    want = REF_OPS.lif_update(jnp.asarray(v), jnp.asarray(el),
                              jnp.asarray(cur), threshold=1.0, leak=0.9)
    got = ops.lif_update(_t(v), _t(el), _t(cur), threshold=1.0, leak=0.9)
    assert all(g.shape == shape for g in got)
    assert got[3].dtype == torch.int8
    _assert_lif_close(got, want, v, el, cur, 0.9)


def test_lif_update_elapsed_across_three_steps():
    """`elapsed` bookkeeping over three steps, each package carrying its
    own state: untouched neurons count idle steps, touched ones restart
    at 0 and apply leak ** (idle + 1) lazily."""
    b, n, leak = 5, 300, 0.8
    v, _, _ = _lif_case(7, (b, n))
    el = np.zeros((b, n), np.int32)
    ref_state = (jnp.asarray(v), jnp.asarray(el))
    state = (_t(v), _t(el))
    rng = np.random.default_rng(8)
    for _ in range(3):
        cur = np.where(rng.random((b, n)) < 0.3, 0.2, 0.0).astype(np.float32)
        want = REF_OPS.lif_update(*ref_state, jnp.asarray(cur),
                                  threshold=1.0, leak=leak)
        got = ops.lif_update(*state, _t(cur), threshold=1.0, leak=leak)
        for i in (1, 2, 3):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-7)
        ref_state, state = want[:2], got[:2]
    idle = state[1].numpy()
    assert idle.max() == 3 and (idle == 0).any()


def test_lif_update_plain_is_core_lif_step():
    from repro_torch.core.neuron import LIFParams, LIFState, lif_step

    v, el, cur = _lif_case(9, (8, 128))
    st, sp, upd = lif_step(LIFState(_t(v), _t(el)), _t(cur),
                           LIFParams(threshold=1.0, leak=0.9))
    vo, eo, spo, updo = LU.lif_update(_t(v), _t(el), _t(cur))
    for a, b in ((st.v, vo), (st.elapsed, eo), (sp, spo),
                 (upd.to(torch.int8), updo)):
        assert torch.equal(a, b)


def test_lif_argtypes_match_the_launch_signature():
    assert LU._ARGTYPES == c_argtypes("lif_update", "lif_update_launch")


@pytest.mark.parametrize("shape,offset", [
    ((32, 4096), None), ((1, 37), None), ((3, 37), None), ((37, 10), None),
    ((1, 10), 0), ((32, 1024), 2)],
    ids=["arch", "n37", "3x37", "37x10", "v-offset-1", "current-offset-1"])
def test_lif_wrapper_passes_the_operands(monkeypatch, shape, offset):
    """On a card the wrapper launches once, in `_ARGTYPES` order: the
    operands' own data pointers (a view at storage offset 1 too), fresh
    outputs and the element count."""
    v, el, cur = (_t(a) for a in _lif_case(3, shape))
    ops_ = [v, el, cur]
    if offset is not None:
        t = ops_[offset]
        moved = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
        moved.copy_(t)
        ops_[offset] = moved
    before = dict(LU.launches)
    calls = launch_args(monkeypatch, LU, lambda: LU.lif_update(*ops_))
    assert LU.launches["lif_update"] == before["lif_update"] + 1
    [(fn, argtypes, args)] = calls
    assert fn == "lif_update_launch" and argtypes == LU._ARGTYPES
    assert len(args) == len(argtypes)
    for a, t in zip(args, argtypes):
        t(a)
    assert args[:3] == tuple(t.data_ptr() for t in ops_)
    assert len(set(args[:7])) == 7
    assert args[7] == v.numel()


# ---------------------------------------------------------------------------
# the padded fused-timestep entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codebook,block", [(True, None), (False, (8, 32)),
                                            (True, (4, 64))],
                         ids=["codebook", "dense-block", "codebook-block"])
def test_fused_timestep_matches_reference(codebook, block):
    rng = np.random.default_rng(4)
    m, k, n = 5, 40, 48
    s = (rng.random((m, k)) < 0.3).astype(np.float32)
    cb = np.sort(rng.normal(0, 0.4, 16)).astype(np.float32)
    cb[np.argmin(np.abs(cb))] = 0.0
    idx = rng.integers(0, 16, (k, n)).astype(np.int8)
    cbw = np.broadcast_to(cb[:, None], (16, n)).copy()
    dense = cb[idx]
    v = rng.normal(0.5, 0.5, (m, n)).astype(np.float32)
    el = rng.integers(0, 6, (m, n)).astype(np.int32)
    w, table = (idx, cbw) if codebook else (dense, None)
    want = REF_OPS.fused_timestep(
        jnp.asarray(s), jnp.asarray(w), jnp.asarray(v), jnp.asarray(el),
        codebook=None if table is None else jnp.asarray(table), block=block)
    vt, elt = _t(v), _t(el)
    got = ops.fused_timestep(_t(s), _t(w), vt, elt,
                             codebook=None if table is None else _t(table),
                             block=block)
    assert torch.equal(vt, _t(v)) and torch.equal(elt, _t(el))
    v_int = np.asarray(jnp.asarray(v) * 0.9 ** (jnp.asarray(el) + 1)
                       .astype(jnp.float32) + jnp.asarray(s)
                       @ jnp.asarray(dense))
    assert_step_close(want, [t.numpy() for t in got], v_int,
                      touched=np.asarray(want[3]))


# ---------------------------------------------------------------------------
# plain oracles
# ---------------------------------------------------------------------------

def test_ref_oracles_match_reference():
    rng = np.random.default_rng(6)
    x, idx, cb = _codebook_case(6, 9, 33, 24, 16)
    grouped = np.sort(rng.normal(0, 1, (4, 8)), axis=1).astype(np.float32)
    idx8 = (idx % 8).astype(np.int8)
    for c, ix in ((cb, idx), (grouped, idx8)):
        np.testing.assert_allclose(
            ref.codebook_matmul_ref(_t(x), _t(ix), _t(c)).numpy(),
            np.asarray(REF_REF.codebook_matmul_ref(
                jnp.asarray(x), jnp.asarray(ix), jnp.asarray(c))),
            rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="do not divide"):
        ref.codebook_matmul_ref(_t(x), _t(idx), torch.zeros(5, 8))
    s = (rng.random((9, 33)) < 0.2).astype(np.int8)
    np.testing.assert_allclose(
        ref.zspe_spmm_ref(_t(s), _t(x.T[:, :24].copy())).numpy(),
        np.asarray(REF_REF.zspe_spmm_ref(jnp.asarray(s),
                                         jnp.asarray(x.T[:, :24]))),
        rtol=1e-5, atol=1e-5)
    # the zspe kernel's semantics in core/zspe.py: the plain product, also
    # against a quantized tensor
    q = REF_Q.quantize(jnp.asarray(x.T[:, :24]), REF_Q.CodebookConfig())
    qt = Q.QuantizedTensor(idx=_t(q.idx), codebook=_t(q.codebook),
                           scale=_t(q.scale),
                           group_axis_size=q.group_axis_size)
    sf = s.astype(np.float32)
    np.testing.assert_allclose(
        Z.zspe_matmul_q(_t(sf), qt).numpy(),
        np.asarray(REF_Z.zspe_matmul_q(jnp.asarray(sf), q)), rtol=1e-5,
        atol=1e-5)
    assert torch.equal(Z.zspe_matmul(_t(sf), _t(x.T[:, :24].copy())),
                       ref.zspe_spmm_ref(_t(sf), _t(x.T[:, :24].copy())))
    v, el, cur = _lif_case(10, (6, 50))
    want = REF_REF.lif_update_ref(jnp.asarray(v), jnp.asarray(el),
                                  jnp.asarray(cur), threshold=1.0, leak=0.9,
                                  reset=0.0)
    got = ref.lif_update_ref(_t(v), _t(el), _t(cur), threshold=1.0, leak=0.9,
                             reset=0.0)
    assert got[3].dtype == torch.bool
    _assert_lif_close(got, want, v, el, cur, 0.9)


# ---------------------------------------------------------------------------
# the slice as a whole: examples/quickstart.py through both packages
# ---------------------------------------------------------------------------

def _quickstart(C, ops_mod, asarray, dequantize, quantize_kw):
    """examples/quickstart.py's flow; returns every number it prints."""
    rng = np.random.default_rng(0)
    w = asarray(rng.normal(0, 0.02, (512, 256)).astype(np.float32))
    q = C.quantize(w, C.CodebookConfig(n_levels=16, bit_width=8),
                   **quantize_kw)
    wq = dequantize(q)
    wn, wqn = np.asarray(w), np.asarray(wq)
    rel = float(np.sqrt(np.mean((wqn - wn) ** 2)) / wn.std())
    spikes = asarray((rng.random((128, 512)) < 0.05).astype(np.float32))
    out, skipped = ops_mod.zspe_spmm(spikes, wq, with_stats=True)
    v = asarray(np.zeros((128, 256), np.float32))
    elapsed = asarray(np.zeros((128, 256), np.int32))
    _, _, fired, touched = ops_mod.lif_update(v, elapsed, out)
    m = C.fullerene_metrics()
    rep = C.simulate_traffic(C.fullerene_adjacency(),
                             [(12, [20, 25, 30], 64), (15, [31], 64)])
    core = C.calibrate_core()
    chip = C.calibrate_chip(core)
    ints = dict(skipped=int(skipped.sum()), fired=int(fired.sum()),
                delivered=rep.spikes_delivered, modes=rep.mode_counts,
                shape=tuple(out.shape), table=tuple(q.codebook.shape))
    floats = dict(rel=rel, degree=m.avg_degree, var=m.degree_variance,
                  hops=m.avg_core_hops, fj_hop=rep.pj_per_spike_hop * 1e3,
                  gsops=core.gsops(1.0), pj_sop=core.pj_per_sop(1.0),
                  chip_pj=chip.chip_pj_per_sop(0.9),
                  gain=core.improvement_vs_baseline())
    return ints, floats, np.asarray(out), np.asarray(touched)


def test_quickstart_flow_matches_reference():
    import types

    import repro.core as REF_C
    from repro_torch.core import energy, noc, quant

    port_c = types.SimpleNamespace(
        quantize=quant.quantize, CodebookConfig=quant.CodebookConfig,
        fullerene_metrics=noc.fullerene_metrics,
        simulate_traffic=noc.simulate_traffic,
        fullerene_adjacency=noc.fullerene_adjacency,
        calibrate_core=energy.calibrate_core,
        calibrate_chip=energy.calibrate_chip)
    ref_ints, ref_floats, ref_cur, ref_touched = _quickstart(
        REF_C, REF_OPS, jnp.asarray, REF_C.dequantize, {})
    ints, floats, cur, touched = _quickstart(
        port_c, ops, torch.as_tensor, quant.dequantize, {"device": "cpu"})
    assert ints == ref_ints
    for key, want in ref_floats.items():
        np.testing.assert_allclose(floats[key], want, rtol=1e-6,
                                   err_msg=key)
    # the printed touched count (`current != 0`) is held element by
    # element: it agrees except where the codebook's fixed-point levels
    # cancel, a current exactly 0 in one framework being a rounding residue
    # within 1e-7 of 0 in the other
    differ = touched != ref_touched
    assert differ.sum() <= 0.001 * differ.size
    assert (np.abs(cur[differ]) < 1e-7).all()
    assert (np.abs(ref_cur[differ]) < 1e-7).all()
