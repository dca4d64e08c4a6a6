"""The port's core/zspe.py, core/quant.py and core/neuron.py against the
reference: packed spike words and register-word round trips bit-exact,
k-means codebooks to the ulp, `lif_step` within one ulp."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import neuron as REF_N  # noqa: E402
from repro.core import quant as REF_Q  # noqa: E402
from repro.core import zspe as REF_Z  # noqa: E402

from repro_torch.core import neuron as N  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.core import zspe as Z  # noqa: E402


@pytest.mark.parametrize("m,k,density", [(1, 16, 0.5), (5, 70, 0.2),
                                         (3, 200, 0.0), (4, 33, 1.0)])
def test_spike_words_bit_exact(m, k, density):
    rng = np.random.default_rng(m * 1000 + k)
    s = (rng.random((m, k)) < density).astype(np.float32)
    want = np.asarray(REF_Z.pack_spike_words(jnp.asarray(s)))
    got = Z.pack_spike_words(torch.as_tensor(s))
    assert got.dtype == torch.uint16 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy()
                                  .view(np.uint16), want)
    np.testing.assert_array_equal(
        Z.unpack_spike_words(got, k).numpy(),
        np.asarray(REF_Z.unpack_spike_words(jnp.asarray(want), k)))
    np.testing.assert_array_equal(
        Z.empty_spike_words(got).numpy(),
        np.asarray(REF_Z.empty_spike_words(jnp.asarray(want))))
    assert Z.spike_word_count(k) == REF_Z.spike_word_count(k)


def test_high_bit_survives_uint16():
    s = torch.zeros((1, 16))
    s[0, 15] = 1.0
    words = Z.pack_spike_words(s)
    assert int(Z.words_as_int32(words)[0, 0]) == 1 << 15
    np.testing.assert_array_equal(Z.unpack_spike_words(words).numpy(),
                                  s.numpy())


def test_cycle_model_arrays_equal():
    rng = np.random.default_rng(1)
    slices = rng.integers(1, 300, (1, 5)).astype(np.float32)
    nnz = rng.integers(0, 50, (4, 1)).astype(np.float32)
    touched = rng.integers(0, 300, (4, 5)).astype(np.float32)
    for zs in (True, False):
        for pu in (True, False):
            got = Z.CycleModel().timestep_cycles_array(
                97, torch.as_tensor(slices), torch.as_tensor(nnz),
                torch.as_tensor(touched), zs, pu)
            want = REF_Z.CycleModel().timestep_cycles_array(
                97, jnp.asarray(slices), jnp.asarray(nnz),
                jnp.asarray(touched), zs, pu)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ref_q(w, cfg):
    return REF_Q.quantize(jnp.asarray(w), REF_Q.CodebookConfig(
        cfg.n_levels, cfg.bit_width, group_size=cfg.group_size,
        zero_level=cfg.zero_level))


@pytest.mark.parametrize("group_size", [0, 16])
@pytest.mark.parametrize("zero_level", [False, True])
def test_quantize_matches_reference(group_size, zero_level):
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.5, (96, 48)).astype(np.float32)
    cfg = Q.CodebookConfig(16, 8, group_size=group_size,
                           zero_level=zero_level)
    got = Q.quantize(w, cfg, device="cpu")
    want = _ref_q(w, cfg)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    # k-means sums run in another order: centroids agree to a few ulp
    cb = np.asarray(want.codebook)
    np.testing.assert_allclose(got.codebook.numpy(), cb, rtol=0,
                               atol=4 * np.spacing(np.abs(cb).max()))
    np.testing.assert_array_equal(
        Q.codebook_to_words(got.codebook, got.scale, 8),
        REF_Q.codebook_to_words(want.codebook, want.scale, 8))
    assert got.group_axis_size == want.group_axis_size
    if zero_level:
        assert (got.codebook == 0).sum(-1).min() >= 1


def _tree_colsum_numpy(m: np.ndarray) -> np.ndarray:
    """`quant._tree_colsum`'s pairs, one f32 add at a time in numpy."""
    m = m.astype(np.float32)
    while m.shape[0] > 1:
        h = m.shape[0] // 2
        top = m[:h] + m[h:2 * h]
        if m.shape[0] % 2:
            top[h - 1] = top[h - 1] + m[2 * h]
        m = top
    return m[0]


@pytest.mark.parametrize("rows", [1, 2, 3, 7, 1000, 100003])
def test_cluster_sums_do_not_depend_on_the_layout(rows):
    """k-means cluster sums take pairs fixed by the row count alone, so a
    fit is bitwise the same on every device (on an H100 against the CPU,
    `sum(dim=0)`'s device-chosen order moved one index of 13.7 M in
    ARCH's per-core fits).  The same matrix in another memory layout or
    with fewer columns sums bitwise alike, and equals the pairs added one
    at a time.  The tree reduces in place, into the matrix's first row,
    and returns a copy of it: a view would hold the whole matrix alive."""
    m = torch.randn(rows, 16, generator=torch.Generator().manual_seed(rows))
    work = m.clone()
    got = Q._tree_colsum(work)
    assert torch.equal(work[0], got)
    assert (got.untyped_storage().data_ptr()
            != work.untyped_storage().data_ptr())
    np.testing.assert_array_equal(got.numpy(),
                                  _tree_colsum_numpy(m.numpy()))
    assert torch.equal(Q._tree_colsum(m.t().contiguous().t()), got)
    assert torch.equal(Q._tree_colsum(m[:, :3].contiguous()), got[:3])


@pytest.mark.parametrize("n,w", [(4, 4), (8, 8), (16, 8), (16, 16)])
def test_register_words_round_trip_bit_exact(n, w):
    from repro_torch import convert

    rng = np.random.default_rng(n * 31 + w)
    wt = rng.normal(0, 0.5, (40, 32)).astype(np.float32)
    ref = REF_Q.quantize(jnp.asarray(wt), REF_Q.CodebookConfig(n, w,
                                                               group_size=8))
    q = convert([dict(idx=np.asarray(ref.idx),
                      codebook=np.asarray(ref.codebook),
                      scale=np.asarray(ref.scale),
                      group_axis_size=ref.group_axis_size)],
                device="cpu").weights[0]
    words = Q.codebook_to_words(q.codebook, q.scale, w)
    np.testing.assert_array_equal(
        words, REF_Q.codebook_to_words(ref.codebook, ref.scale, w))
    np.testing.assert_array_equal(
        Q.words_to_codebook(words, q.scale).numpy(),
        np.asarray(REF_Q.words_to_codebook(words, ref.scale)))
    np.testing.assert_array_equal(
        Q.dequantize_via_registers(q, w).numpy(),
        np.asarray(REF_Q.dequantize_via_registers(ref, w)))
    np.testing.assert_array_equal(Q.dequantize(q).numpy(),
                                  np.asarray(REF_Q.dequantize(ref)))
    assert Q.infer_bit_width(q) == REF_Q.infer_bit_width(ref)
    cfg = Q.CodebookConfig(n, w)
    ref_cfg = REF_Q.CodebookConfig(n, w)
    for lo, hi in ((0, 8), (8, 16), (24, 32)):
        assert Q.register_entry_for_slice(q, cfg, lo, hi) == \
            REF_Q.register_entry_for_slice(ref, ref_cfg, lo, hi)
    with pytest.raises(ValueError, match="spans codebook"):
        Q.register_entry_for_slice(q, cfg, 4, 12)


@pytest.mark.parametrize("partial_update", [True, False])
def test_lif_step_within_one_ulp(partial_update):
    rng = np.random.default_rng(11)
    shape = (6, 257)
    v = rng.normal(0.3, 0.5, shape).astype(np.float32)
    el = rng.integers(0, 40, shape).astype(np.int32)
    cur = rng.normal(0, 0.5, shape).astype(np.float32)
    cur[rng.random(shape) < 0.3] = 0.0
    touched = rng.random(shape) < 0.6
    p = N.LIFParams(partial_update=partial_update)
    rp = REF_N.LIFParams(partial_update=partial_update)
    st, sp, up = N.lif_step(N.LIFState(torch.as_tensor(v),
                                       torch.as_tensor(el)),
                            torch.as_tensor(cur), p,
                            touched=torch.as_tensor(touched))
    rst, rsp, rup = REF_N.lif_step(REF_N.LIFState(jnp.asarray(v),
                                                  jnp.asarray(el)),
                                   jnp.asarray(cur), rp,
                                   touched=jnp.asarray(touched))
    np.testing.assert_array_equal(st.elapsed.numpy(), np.asarray(rst.elapsed))
    np.testing.assert_array_equal(up.numpy(), np.asarray(rup))
    same = sp.numpy() == np.asarray(rsp)
    # `leak ** pending` differs by an ulp between the frameworks (and only
    # that differs): where the decays agree, v' is bit-exact; elsewhere v'
    # is off by at most one ulp of the decayed product v * decay plus the
    # rounding of the sum, one ulp of v'.  A spike
    # could flip only at the threshold itself.
    pend = el + 1 if partial_update else np.ones_like(el)
    decay = (0.9 ** torch.as_tensor(pend).float()).numpy()
    ref_decay = np.asarray(0.9 ** jnp.asarray(pend).astype(jnp.float32))
    np.testing.assert_array_max_ulp(decay, ref_decay, maxulp=1)
    v_int = v * ref_decay + cur
    assert (same | (np.abs(v_int - 1.0) < 1e-6)).all()
    got_v, want_v = st.v.numpy(), np.asarray(rst.v)
    exact = same & (decay == ref_decay)
    np.testing.assert_array_equal(got_v[exact], want_v[exact])
    off = same & ~exact
    assert (np.abs(got_v - want_v)[off]
            <= (np.spacing(np.abs(v * ref_decay))
                + np.spacing(np.abs(want_v)))[off]).all()


def test_touch_mask_and_init_state():
    rng = np.random.default_rng(2)
    s = (rng.random((3, 20)) < 0.3).astype(np.float32)
    nz = (rng.random((20, 8)) < 0.4).astype(np.float32)
    np.testing.assert_array_equal(
        N.touch_mask(torch.as_tensor(s), torch.as_tensor(nz)).numpy(),
        np.asarray(REF_N.touch_mask(jnp.asarray(s), jnp.asarray(nz))))
    st = N.init_state(5, (2,), device="cpu")
    assert st.v.shape == (2, 5) and st.elapsed.dtype == torch.int32


def test_init_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        N.init_state(5, (2,))


def _lif_inputs(seed, shape, steps=None):
    rng = np.random.default_rng(seed)
    v = rng.normal(0.3, 0.5, shape).astype(np.float32)
    el = rng.integers(0, 40, shape).astype(np.int32)
    cur = rng.normal(0, 0.5, ((steps,) if steps else ()) + shape).astype(
        np.float32)
    cur[rng.random(cur.shape) < 0.3] = 0.0
    return v, el, cur


def _hold_v(got_v, want_v, v_scale, steps: int = 1):
    """The one-ulp LIF rule of `test_lif_step_within_one_ulp`, once per
    step: v' off by at most one ulp of the decayed product plus one of
    the sum, each step adding its own (of the largest state seen)."""
    bound = steps * 2 * np.spacing(np.float32(v_scale))
    assert np.all(np.abs(got_v - want_v) <= bound), float(
        np.abs(got_v - want_v).max())


def test_dense_reference_step_within_one_ulp():
    v, el, cur = _lif_inputs(12, (6, 257))
    for reset_mode in ("hard", "soft"):
        p = N.LIFParams(reset_mode=reset_mode)
        rp = REF_N.LIFParams(reset_mode=reset_mode)
        st, sp = N.dense_reference_step(
            N.LIFState(torch.as_tensor(v), torch.as_tensor(el)),
            torch.as_tensor(cur), p)
        rst, rsp = REF_N.dense_reference_step(
            REF_N.LIFState(jnp.asarray(v), jnp.asarray(el)), jnp.asarray(cur),
            rp)
        v_int = v * np.float32(0.9) + cur
        assert not (np.abs(v_int - 1.0) < 1e-6).any()   # no spike on a tie
        np.testing.assert_array_equal(sp.numpy(), np.asarray(rsp))
        np.testing.assert_array_equal(st.elapsed.numpy(),
                                      np.asarray(rst.elapsed))
        assert not st.elapsed.any()              # the dense scheme's
        _hold_v(st.v.numpy(), np.asarray(rst.v), np.abs(v_int).max())


@pytest.mark.parametrize("partial_update", [True, False])
def test_run_timesteps_matches_reference(partial_update):
    """Over T = 6 steps: the updates per step and the final `elapsed`
    exact, the spikes equal (the fixture has no potential within 1e-4 of
    the threshold), v' within a one-ulp rule per step; the port's loop
    is a loop of its own `lif_step`, bitwise."""
    steps = 6
    v, el, cur = _lif_inputs(13, (3, 130), steps)
    p = N.LIFParams(partial_update=partial_update)
    rp = REF_N.LIFParams(partial_update=partial_update)
    st0 = N.LIFState(torch.as_tensor(v), torch.as_tensor(el))
    st, sp, ups = N.run_timesteps(st0, torch.as_tensor(cur), p)
    rst, rsp, rups = REF_N.run_timesteps(
        REF_N.LIFState(jnp.asarray(v), jnp.asarray(el)), jnp.asarray(cur), rp)
    assert sp.shape == (steps, 3, 130) and ups.shape == (steps,)
    assert ups.dtype == torch.int32
    np.testing.assert_array_equal(ups.numpy(), np.asarray(rups))
    np.testing.assert_array_equal(st.elapsed.numpy(), np.asarray(rst.elapsed))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(rsp))
    # a loop of the port's own step, bitwise; no potential near the
    # threshold at any step
    loop, scale = st0, float(np.abs(v).max())
    for t in range(steps):
        loop, spk, upd = N.lif_step(loop, torch.as_tensor(cur[t]), p)
        assert torch.equal(spk, sp[t]) and int(upd.sum()) == int(ups[t])
        assert not bool(((loop.v - 1.0).abs() < 1e-4).any())
        scale = max(scale, float(loop.v.abs().max()) + 0.5)
    assert torch.equal(loop.v, st.v) and torch.equal(loop.elapsed,
                                                     st.elapsed)
    _hold_v(st.v.numpy(), np.asarray(rst.v), scale, steps)
    from repro_torch.core import run_timesteps
    assert run_timesteps is N.run_timesteps


@pytest.mark.parametrize("n,w", [(4, 4), (16, 8)])
def test_from_register_entry_matches_reference(n, w):
    rng = np.random.default_rng(n + w)
    wt = rng.normal(0, 0.5, (24, 16)).astype(np.float32)
    ref = REF_Q.quantize(jnp.asarray(wt), REF_Q.CodebookConfig(n, w))
    (words, scale), = REF_Q.to_register_entries(ref, REF_Q.CodebookConfig(
        n, w))
    idx = np.asarray(ref.idx).astype(np.int8)
    idx[0, :4] = (-1, n, 127, -128)          # JAX's gather: wrap, clamp
    got = Q.from_register_entry(words, scale, torch.as_tensor(idx))
    want = REF_Q.from_register_entry(words, scale, jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[1:],
                                  np.asarray(REF_Q.dequantize(ref))[1:])


@pytest.mark.parametrize("n", REF_Q.VALID_N)
def test_bits_per_weight_matches_reference(n):
    got = Q.CodebookConfig(n_levels=n).bits_per_weight()
    assert got == REF_Q.CodebookConfig(n_levels=n).bits_per_weight()
    assert isinstance(got, float)


@pytest.mark.parametrize("zero_skip,partial_update",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
def test_sop_count_and_gsops_match_reference(zero_skip, partial_update):
    """The scalar throughput model at the ARCH layers' (n_pre, n_post)
    over sparsities 0 .. 1, and the SOPs at fractional nnz."""
    got, want = Z.CycleModel(), REF_Z.CycleModel()
    for n_pre, n_post in ((2312, 4096), (4096, 1024), (1024, 10), (1, 1)):
        for sparsity in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert got.gsops(n_pre, n_post, sparsity, zero_skip,
                             partial_update) == want.gsops(
                n_pre, n_post, sparsity, zero_skip, partial_update)
        for nnz in (0.0, 3.0, 17.25):
            assert got.sop_count(n_pre, n_post, nnz, zero_skip) == \
                want.sop_count(n_pre, n_post, nnz, zero_skip)
