"""The plain version of the port's fused-timestep kernel against the
reference's Pallas entry points (interpret mode), teacher-forced: the same
spike words, weights and state through both, held to the harness contract.
Plus the wrapper's CPU behaviour: in place, uncounted, validated."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import fused_timestep as REF  # noqa: E402
from test_torch_harness import assert_step_close  # noqa: E402

from repro_torch.core import zspe as Z  # noqa: E402
from repro_torch.kernels import fused_timestep as FT  # noqa: E402


def _case(seed, m, k, n, density, all_nonzero, levels=16):
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


@pytest.mark.parametrize("codebook", [True, False], ids=["codebook", "dense"])
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("k", [40, 64])
@pytest.mark.parametrize("all_nonzero", [False, True])
@pytest.mark.parametrize("partial_update", [True, False],
                         ids=["partial", "full"])
def test_plain_matches_reference(codebook, m, k, all_nonzero,
                                 partial_update):
    n = 48
    for density in (0.0, 0.3):
        c = _case(m * 100 + k, m, k, n, density, all_nonzero)
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
