"""The port's flash-attention module against the JAX package's.

On the CPU `repro_torch.kernels.flash_attention.flash_attention` runs its
plain version (GQA by repeat, one-pass f32 softmax); it is held to the
reference's Pallas kernel in interpret mode (online softmax over 128-key
blocks) and to the reference's oracle.  The CUDA kernel itself is checked
on the card (`tests/test_torch_cuda.py`, `chip_smoke.py` phase 6).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as TREF

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import flash_attention as RFA  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402

# f32: the one-pass softmax and the online one (128-key blocks, rescaled
# partial sums) round differently, and XLA and torch sum the f32 products
# in different orders: a few ulp of values of size ~1.
F32_TOL = 2e-5
# bf16: p and the output are rounded to bf16 in the kernel, not in the
# oracle; the reference's own bf16 test allows 5e-2.
BF16_TOL = 2e-2


def _qkv(seed, b, h, kv, s, t, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, s, hd)).astype(dtype),
            rng.normal(0, 1, (b, kv, t, hd)).astype(dtype),
            rng.normal(0, 1, (b, kv, t, hd)).astype(dtype))


def _port(q, k, v, causal, dtype=torch.float32):
    return FA.flash_attention(*(torch.tensor(a).to(dtype) for a in (q, k, v)),
                              causal=causal)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_matches_reference_kernel_and_oracle(hd, group, causal):
    h = 4
    q, k, v = _qkv(hd * 10 + group, 1, h, h // group, 256, 256, hd)
    got = _port(q, k, v, causal).numpy()
    want = np.asarray(RFA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    kb, vb = (np.repeat(a, group, axis=1) for a in (k, v))
    oracle = np.asarray(RREF.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), causal=causal))
    np.testing.assert_allclose(got, oracle, rtol=F32_TOL, atol=F32_TOL)
    assert FA.launches["flash_attention"] == 0     # the CPU runs no kernel


def test_bf16_matches_reference_kernel():
    q, k, v = _qkv(3, 1, 2, 1, 256, 256, 64)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(RFA.flash_attention(qj, kj, vj, causal=True),
                      np.float32)
    got = _port(q, k, v, True, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_TOL)


def test_unequal_lengths_match_reference():
    """S != T (both multiples of 128), as the reference's kernel allows."""
    q, k, v = _qkv(5, 2, 2, 2, 128, 384, 32)
    for causal in (True, False):
        got = _port(q, k, v, causal).numpy()
        want = np.asarray(RFA.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_gqa_unexpanded_equals_expanded():
    q, k, v = _qkv(7, 2, 8, 2, 256, 256, 16)
    qt, kt, vt = (torch.tensor(a) for a in (q, k, v))
    got = FA.flash_attention(qt, kt, vt)
    want = FA.flash_attention(qt, kt.repeat_interleave(4, 1),
                              vt.repeat_interleave(4, 1))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt")])
def test_route_takes_tensor_cores_for_bf16_at_64_and_128(dtype, hd, route):
    """bf16 at the dense configs' head dims (64, 128) runs the wgmma
    kernel; f32 stays on the SIMT kernel (f32 dots, no TF32)."""
    assert FA._route(dtype, hd) == route


def test_plain_version_is_the_oracle():
    q, k, v = (torch.tensor(a) for a in _qkv(9, 1, 2, 2, 128, 128, 16))
    assert torch.equal(FA.flash_attention_plain(q, k, v, causal=False),
                       TREF.flash_attention_ref(q, k, v, causal=False))


@pytest.mark.parametrize("shapes,match", [
    (((1, 2, 200, 16), (1, 2, 256, 16)), "multiples of 128"),
    (((1, 2, 256, 16), (1, 2, 192, 16)), "multiples of 128"),
    (((1, 3, 128, 16), (1, 2, 128, 16)), "multiple of 2 kv heads"),
    (((1, 2, 128, 16), (2, 2, 128, 16)), "batch or head dim"),
    (((2, 128, 16), (2, 128, 16)), r"\(B, H, S, hd\)"),
])
def test_shape_checks_raise(shapes, match):
    qs, ks = shapes
    with pytest.raises(ValueError, match=match):
        FA.flash_attention(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks))


def test_type_and_layout_checks_raise():
    q = torch.zeros(1, 2, 128, 16)
    with pytest.raises(TypeError, match="q must be"):
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="k must be"):
        FA.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q, q.transpose(2, 3).contiguous().transpose(2, 3),
                           q)


@pytest.mark.parametrize("args", [(1, 1, 128, 128, 64, 2, False),
                                  (2, 8, 512, 512, 64, 2, True),
                                  (4, 32, 512, 1024, 128, 4, False)])
def test_hbm_io_bytes_equals_reference(args):
    *shape, nbytes, bwd = args
    assert FA.hbm_io_bytes(*shape, nbytes, with_backward=bwd) == \
        RFA.hbm_io_bytes(*shape, nbytes, with_backward=bwd)
