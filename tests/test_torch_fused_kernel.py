"""The plain version of the port's fused-timestep kernel against the
reference's Pallas entry points (interpret mode), teacher-forced: the same
spike words, weights and state through both, held to the harness contract
(dense weights as codebook levels and as Gaussian f32 with exact 0.0 and
-0.0 among them); int8 indexes outside [0, L) against the reference's
device path (`gather=False`), also through the padded
`ops.fused_timestep`.  Plus the wrapper's CPU behaviour (in place,
uncounted, validated), both variants' launch plan and the arguments the
wrapper passes to the C launch functions."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import fused_timestep as REF  # noqa: E402
from test_torch_harness import (assert_step_close, c_argtypes,  # noqa: E402
                                launch_args)

from repro_torch.core import zspe as Z  # noqa: E402
from repro_torch.kernels import fused_timestep as FT  # noqa: E402


def _case(seed, m, k, n, density, all_nonzero, levels=16, gauss=False):
    """With `gauss`, the dense weights are Gaussian f32 (a tenth 0.0 and a
    tenth -0.0 unless all_nonzero) instead of the indexes' levels."""
    rng = np.random.default_rng(seed)
    kw = Z.spike_word_count(k)
    kp = kw * Z.SPIKE_WORD_BITS
    s = (rng.random((m, k)) < density).astype(np.float32)
    cb = np.sort(rng.normal(0, 0.4, levels)).astype(np.float32)
    if all_nonzero:
        cb[cb == 0] = 1e-3
    else:
        cb[np.argmin(np.abs(cb))] = 0.0
    idx = np.zeros((kp, n), np.int8)
    idx[:k] = rng.integers(0, levels, (k, n))
    cbw = np.broadcast_to(cb[:, None], (levels, n)).copy()
    dense = cb[idx] * (np.arange(kp) < k)[:, None]
    if gauss:
        dense = np.zeros((kp, n), np.float32)
        dense[:k] = rng.normal(0, 0.4, (k, n))
        if not all_nonzero:
            share = rng.random((k, n))
            dense[:k][share < 0.1] = 0.0
            dense[:k][(share >= 0.1) & (share < 0.2)] = -0.0
    packed = Z.pack_spike_words(torch.as_tensor(s))
    return dict(
        s=np.pad(s, ((0, 0), (0, kp - k))),
        packed=packed, packed_np=packed.view(torch.int16).numpy()
        .view(np.uint16),
        idx=idx, cbw=cbw, dense=dense.astype(np.float32),
        v=rng.normal(0.5, 0.5, (m, n)).astype(np.float32),
        el=rng.integers(0, 6, (m, n)).astype(np.int32))


def _ref_v_int(c, partial_update, leak=0.9):
    s, w = jnp.asarray(c["s"]), jnp.asarray(c["dense"])
    v, el = jnp.asarray(c["v"]), jnp.asarray(c["el"])
    decay = leak ** (el + 1).astype(jnp.float32) if partial_update else leak
    return np.asarray(v * decay + s @ w)


@pytest.mark.parametrize("weights", ["codebook", "dense", "dense-gauss"])
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("k", [40, 64])
@pytest.mark.parametrize("all_nonzero", [False, True])
@pytest.mark.parametrize("partial_update", [True, False],
                         ids=["partial", "full"])
def test_plain_matches_reference(weights, m, k, all_nonzero,
                                 partial_update):
    """Codebook indexes; dense weights equal to their levels; Gaussian
    dense weights with 0.0 and -0.0 among them, which touch nothing."""
    n = 48
    codebook = weights == "codebook"
    for density in (0.0, 0.3):
        c = _case(m * 100 + k, m, k, n, density, all_nonzero,
                  gauss=weights == "dense-gauss")
        if weights == "dense-gauss" and not all_nonzero:
            assert np.signbit(c["dense"][c["dense"] == 0]).any()
        lif = dict(threshold=1.0, leak=0.9, reset=0.0,
                   partial_update=partial_update, all_nonzero=all_nonzero)
        if codebook:
            ref = REF.fused_timestep_codebook(
                jnp.asarray(c["packed_np"]), jnp.asarray(c["idx"]),
                jnp.asarray(c["cbw"]), jnp.asarray(c["v"]),
                jnp.asarray(c["el"]), interpret=True, **lif)
            got = FT.fused_timestep_plain(
                c["packed"], torch.as_tensor(c["idx"]),
                torch.as_tensor(c["cbw"]), torch.as_tensor(c["v"]),
                torch.as_tensor(c["el"]), **lif)
        else:
            ref = REF.fused_timestep_dense(
                jnp.asarray(c["packed_np"]), jnp.asarray(c["dense"]),
                jnp.asarray(c["v"]), jnp.asarray(c["el"]), interpret=True,
                **lif)
            got = FT.fused_timestep_plain(
                c["packed"], torch.as_tensor(c["dense"]), None,
                torch.as_tensor(c["v"]), torch.as_tensor(c["el"]), **lif)
        assert_step_close(ref, [t.numpy() for t in got],
                          _ref_v_int(c, partial_update),
                          touched=np.asarray(ref[3]) if partial_update
                          else None)


def test_wrapper_on_cpu_updates_in_place_and_counts_nothing():
    c = _case(1, 4, 40, 48, 0.3, False)
    v, el = torch.as_tensor(c["v"]).clone(), torch.as_tensor(c["el"]).clone()
    idx, cbw = torch.as_tensor(c["idx"]), torch.as_tensor(c["cbw"])
    want = FT.fused_timestep_plain(c["packed"], idx, cbw, v.clone(),
                                   el.clone(), threshold=1.0, leak=0.9,
                                   reset=0.0, partial_update=True,
                                   all_nonzero=False)
    before = dict(FT.launches)
    out = FT.fused_timestep_codebook(c["packed"], idx, cbw, v, el)
    assert out[0] is v and out[1] is el
    for g, w in zip(out, want):
        assert torch.equal(g, w)
    assert FT.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    c = _case(2, 4, 40, 48, 0.3, False)
    v, el = torch.as_tensor(c["v"]), torch.as_tensor(c["el"])
    idx, cbw = torch.as_tensor(c["idx"]), torch.as_tensor(c["cbw"])
    with pytest.raises(TypeError, match="idx must be torch.int8"):
        FT.fused_timestep_codebook(c["packed"], idx.long(), cbw, v, el)
    with pytest.raises(TypeError, match="elapsed must be torch.int32"):
        FT.fused_timestep_codebook(c["packed"], idx, cbw, v, el.long())
    with pytest.raises(ValueError, match="weights must be"):
        FT.fused_timestep_codebook(c["packed"], idx[:16], cbw, v, el)
    with pytest.raises(ValueError, match="contiguous"):
        FT.fused_timestep_codebook(c["packed"], idx, cbw,
                                   v.t().contiguous().t(), el)
    with pytest.raises(ValueError, match="cbw must be"):
        FT.fused_timestep_codebook(c["packed"], idx, cbw[:, :8], v, el)
    with pytest.raises(TypeError, match="weights must be torch.float32"):
        FT.fused_timestep_dense(c["packed"], idx, v, el)


# ---------------------------------------------------------------------------
# indexes outside [0, L): the reference's device path gives them weight 0
# ---------------------------------------------------------------------------

OUT_OF_RANGE = [((-3, 20), 16), ((-128, 128), 8)]   # ([lo, hi), L)


def _out_of_range_case(seed, m, k, n, lo, hi, levels, density=0.5):
    rng = np.random.default_rng(seed)
    kp = Z.spike_word_count(k) * Z.SPIKE_WORD_BITS
    s = (rng.random((m, k)) < density).astype(np.float32)
    idx = rng.integers(lo, hi, (kp, n)).astype(np.int8)
    cbw = rng.normal(0, 0.4, (levels, n)).astype(np.float32)
    cbw[levels // 2, : n // 2] = 0.0                 # a zero level as well
    return dict(s=s, packed=Z.pack_spike_words(torch.as_tensor(s)), idx=idx,
                cbw=cbw, v=rng.normal(0.5, 0.5, (m, n)).astype(np.float32),
                el=rng.integers(0, 6, (m, n)).astype(np.int32))


def _assert_matches_device_path(got, ref):
    """Integers equal, v' within 1e-5 relative (the reference's float
    program is the same up to the matmul's rounding)."""
    got = [np.asarray(x) for x in got]
    ref = [np.asarray(x) for x in ref]
    for i in (1, 2, 3, 4, 5):
        np.testing.assert_array_equal(got[i].reshape(ref[i].shape), ref[i],
                                      err_msg=f"output {i}")
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rng_range,levels", OUT_OF_RANGE,
                         ids=["-3..19-L16", "int8-L8"])
@pytest.mark.parametrize("partial_update", [True, False],
                         ids=["partial", "full"])
def test_plain_out_of_range_matches_reference_device_path(
        rng_range, levels, partial_update):
    """The plain version against the reference's compare-and-select
    dequant (`gather=False`, the path it runs on a device), with int8
    indexes outside [0, L) among the spiking rows."""
    (lo, hi) = rng_range
    c = _out_of_range_case(3, 4, 32, 8, lo, hi, levels)
    assert ((c["idx"] < 0) | (c["idx"] >= levels)).mean() > 0.1
    lif = dict(threshold=1.0, leak=0.9, reset=0.0,
               partial_update=partial_update, all_nonzero=False)
    ref = REF.fused_timestep_codebook(
        jnp.asarray(c["packed"].view(torch.int16).numpy().view(np.uint16)),
        jnp.asarray(c["idx"]), jnp.asarray(c["cbw"]), jnp.asarray(c["v"]),
        jnp.asarray(c["el"]), gather=False, interpret=True, **lif)
    got = FT.fused_timestep_plain(
        c["packed"], torch.as_tensor(c["idx"]), torch.as_tensor(c["cbw"]),
        torch.as_tensor(c["v"]), torch.as_tensor(c["el"]), **lif)
    _assert_matches_device_path(got, ref)


@pytest.mark.parametrize("rng_range,levels", OUT_OF_RANGE,
                         ids=["-3..19-L16", "int8-L8"])
@pytest.mark.parametrize("partial_update", [True, False],
                         ids=["partial", "full"])
def test_ops_out_of_range_matches_reference_device_path(
        rng_range, levels, partial_update):
    """The port's padded `ops.fused_timestep` on the CPU against the
    reference's raw `gather=False` call on the same padded inputs (the
    reference's `ops.fused_timestep` passes `gather=True` in interpret
    mode, so it cannot serve here)."""
    from repro_torch.kernels import ops

    (lo, hi) = rng_range
    m, k, n, block = 5, 37, 12, (8, 16)
    c = _out_of_range_case(4, m, k, n, lo, hi, levels)
    kp = c["idx"].shape[0]
    got = ops.fused_timestep(
        torch.as_tensor(c["s"]), torch.as_tensor(c["idx"][:k]),
        torch.as_tensor(c["v"]), torch.as_tensor(c["el"]),
        codebook=torch.as_tensor(c["cbw"]), partial_update=partial_update,
        block=block)

    def pad(a, rows, cols):
        return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])))

    packed = c["packed"].view(torch.int16).numpy().view(np.uint16)
    idx = c["idx"].copy()
    idx[k:] = 0                                      # ops pads K with 0
    ref = REF.fused_timestep_codebook(
        jnp.asarray(pad(packed, 8, packed.shape[1])),
        jnp.asarray(pad(idx, kp, 16)), jnp.asarray(pad(c["cbw"], levels, 16)),
        jnp.asarray(pad(c["v"], 8, 16)), jnp.asarray(pad(c["el"], 8, 16)),
        threshold=1.0, leak=0.9, reset=0.0, partial_update=partial_update,
        gather=False, block=block, interpret=True)
    ref = [np.asarray(r)[:m, :n] for r in ref[:4]] + \
        [np.asarray(r)[:m, 0] for r in ref[4:]]
    _assert_matches_device_path(got, ref)


# ---------------------------------------------------------------------------
# the codebook kernel's launch plan (`_plan`), at the paper's network
# (configs/snn_chip.py ARCH, 2312-4096-1024-10: Kw = 145, 256, 64)
# ---------------------------------------------------------------------------

ARCH_LAYERS = [(145, 4096), (256, 1024), (64, 10)]
SMEM_LIMIT = 232448     # shared memory an H100 block may use
SM_SMEM = 228 * 1024    # ... and an SM, 1 KB of it reserved per block


def _blocks(m, n, plan):
    return -(-m // FT.BM) * -(-n // plan.bn)


@pytest.mark.parametrize("m", [32, 640])
@pytest.mark.parametrize("kw,n", ARCH_LAYERS)
def test_plan_at_arch_layers(m, kw, n):
    plan = FT._plan(m, n, 16)
    assert plan.bn in FT.BNS
    assert plan.smem <= SMEM_LIMIT
    # the narrow tile only where the wide one leaves the grid short
    if plan.bn != max(FT.BNS):
        wide = plan._replace(bn=max(FT.BNS))
        assert _blocks(m, n, wide) < FT.TARGET_BLOCKS


def test_plan_fills_the_card_at_one_step():
    """At M = 32 (one step of the main path) layers 1 and 2 launch about
    one block per SM (the H100 has 132), and the 10-wide layer 3 is no
    longer one block."""
    assert FT._plan(32, 4096, 16).bn == 16
    assert FT._plan(32, 1024, 16).bn == 8
    for _, n in ARCH_LAYERS[:2]:
        assert 100 <= _blocks(32, n, FT._plan(32, n, 16)) <= 264
    _, n = ARCH_LAYERS[2]
    assert _blocks(32, n, FT._plan(32, n, 16)) > 1


@pytest.mark.parametrize("kw", [1, 3, 145, 256, 4096])
def test_word_chunks_cover_every_word_once(kw):
    """The kernel lists the spike words CHUNK_WORDS at a time
    (`for c0w = 0; c0w < Kw; c0w += CHUNK_WORDS`, each chunk cut at Kw):
    Kw that the chunk does not divide (1, 3, 145) still sees each word
    exactly once, and a chunk's k fit the kernel's 16-bit k-list."""
    seen = np.zeros(kw, np.int64)
    for c0w in range(0, kw, FT.CHUNK_WORDS):
        seen[c0w:min(kw, c0w + FT.CHUNK_WORDS)] += 1
    assert (seen == 1).all()
    assert FT.CHUNK_WORDS * Z.SPIKE_WORD_BITS <= 2 ** 16


@pytest.mark.parametrize("levels", [1, 16, 200])
@pytest.mark.parametrize("m,n", [(32, 4096), (32, 1024), (32, 10),
                                 (640, 4096), (1, 37)])
def test_plan_staged_tiles_fit_shared_memory(levels, m, n):
    """The level table (at most 128 levels plus the zero level, as f64),
    the ring and the chunk's arrays fit the H100's 227 KB per block, and
    two blocks fit one SM at the paper's 16 levels."""
    plan = FT._plan(m, n, levels)
    assert plan.smem == FT._smem_bytes(plan.bn, levels) <= SMEM_LIMIT
    assert max(FT._smem_bytes(bn, 10**6) for bn in FT.BNS) <= SMEM_LIMIT
    assert 2 * (FT._smem_bytes(max(FT.BNS), 16) + 1024) <= SM_SMEM


# ---------------------------------------------------------------------------
# the dense variant's plan, and the arguments both wrappers pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [32, 640])
@pytest.mark.parametrize("kw,n", ARCH_LAYERS)
def test_dense_plan_at_arch_layers(m, kw, n):
    plan = FT._plan(m, n, None)
    assert plan.bn in FT.BNS
    assert plan.smem == FT._smem_bytes(plan.bn, None) <= SMEM_LIMIT
    if plan.bn != max(FT.BNS):
        wide = plan._replace(bn=max(FT.BNS))
        assert _blocks(m, n, wide) < FT.TARGET_BLOCKS


def test_dense_plan_fills_the_card_at_one_step():
    """At M = 32 the dense plan launches at least TARGET_BLOCKS tiles at
    ARCH layers 1 and 2 (the 10-wide layer 3 has two columns of tiles at
    most), the widest tile that does so."""
    for _, n in ARCH_LAYERS[:2]:
        plan = FT._plan(32, n, None)
        assert _blocks(32, n, plan) >= FT.TARGET_BLOCKS
        wider = [b for b in FT.BNS if b > plan.bn]
        assert all(_blocks(32, n, plan._replace(bn=b)) < FT.TARGET_BLOCKS
                   for b in wider)
    assert FT._plan(32, 4096, None).bn == 16
    assert FT._plan(32, 1024, None).bn == 8


@pytest.mark.parametrize("bn", FT.BNS)
def test_dense_shared_memory_fits_the_blocks_per_sm_it_assumes(bn):
    """The dense ring (`_dense_stages(bn)` stages of a 4 bn-byte f32 row
    and its mask per thread), the partial tiles it makes room for and the
    chunk's arrays fit 227 KB per block; at BN 16 two blocks of 256
    threads share an SM (the kernel's launch bounds ask for two), at BN 8
    one block of 512."""
    smem = FT._smem_bytes(bn, None)
    threads = FT._block_threads(bn)
    ring = FT._dense_stages(bn) * threads * (4 * bn + 4)
    partials = threads // 32 * (FT.BM * bn * 8 + bn * 4)
    assert smem >= ring + FT._CHUNK_BYTES
    assert smem >= partials + FT._CHUNK_BYTES
    assert smem <= SMEM_LIMIT
    per_sm = 2 if bn == 16 else 1
    assert per_sm * (smem + 1024) <= SM_SMEM
    assert per_sm * threads * 128 <= 65536     # registers at 128 a thread


@pytest.mark.parametrize("name", ["fused_timestep_codebook",
                                  "fused_timestep_dense"])
def test_argtypes_match_the_launch_signature(name):
    assert FT._ARGTYPES[name] == c_argtypes("fused_timestep", f"{name}_launch")


@pytest.mark.parametrize("m,n", [(32, 4096), (32, 1024), (32, 10),
                                 (640, 1024)])
@pytest.mark.parametrize("codebook", [True, False], ids=["codebook", "dense"])
def test_wrapper_passes_the_plan_to_the_launch(monkeypatch, m, n, codebook):
    """On a card the wrapper calls `<name>_launch` with arguments of its
    argtypes, in order: pointers, then m, kw, n (and L), the plan's bn and
    shared bytes, the LIF constants, the flags and the stream."""
    c = _case(5, m, 32, n, 0.3, False)
    v, el = torch.as_tensor(c["v"]), torch.as_tensor(c["el"])
    if codebook:
        name, w0, cbw = ("fused_timestep_codebook", torch.as_tensor(c["idx"]),
                         torch.as_tensor(c["cbw"]))
    else:
        name, w0, cbw = ("fused_timestep_dense", torch.as_tensor(c["dense"]),
                         None)
    before = dict(FT.launches)
    calls = launch_args(monkeypatch, FT, lambda: FT._run(
        name, c["packed"], w0, cbw, v, el, 1.0, 0.9, 0.0, True, False))
    assert FT.launches[name] == before[name] + 1
    [(fn, argtypes, args)] = calls
    assert fn == f"{name}_launch" and argtypes == FT._ARGTYPES[name]
    assert len(args) == len(argtypes)
    for a, t in zip(args, argtypes):
        t(a)                                # each converts to its C type
    n_ptr = 9 if codebook else 8
    ints = list(args[n_ptr:n_ptr + (6 if codebook else 5)])
    plan = FT._plan(m, n, 16 if codebook else None)
    assert ints == [m, 2, n] + ([16] if codebook else []) + list(plan)
