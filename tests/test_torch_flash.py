"""The port's attention kernels' plain versions against the JAX package.

``flash_attention_plain`` and ``flash_decode_plain`` (what the wrappers run
on a CPU tensor) against the Pallas ``flash_attention`` / ``flash_decode``
in interpret mode, over ``tests/test_kernels.py``'s sweep at its
tolerances (f32 2e-5 / 1e-5: the same f32 math summed in another order;
bf16 3e-2: one rounding of the output), and against the ``ref.py`` oracles
at ragged lengths the Pallas kernels refuse. The kernels themselves run
only on the card (``tests/test_torch_cuda.py``). Inputs come from numpy
with a seed and go to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.ref import flash_attention_ref, flash_decode_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(rng, shape, dtype):
    """The same seeded draw as a jax array and a torch CPU tensor."""
    a = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "hq,hk,sq,sk,d",
    [(4, 4, 128, 128, 128), (4, 2, 128, 128, 128), (8, 1, 128, 256, 128), (4, 2, 128, 128, 256)],
)
def test_flash_attention_plain_matches_pallas(hq, hk, sq, sk, d, causal, dtype):
    """test_kernels.py:67-88's sweep and tolerances."""
    rng = np.random.default_rng(hq * 1000 + sk + d + causal)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, s, dtype) for s in ((hq, sq, d), (hk, sk, d), (hk, sk, d))
    )
    want = jax_flash_attention(qj, kj, vj, causal=causal, bq=64, bk=64, interpret=True)
    got = fa.flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == (hq, sq, d)
    tol = 3e-2 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    # the wrapper takes the plain version on a CPU tensor and launches nothing
    before = fa.flash_attention.launches
    np.testing.assert_array_equal(_np(fa.flash_attention(qt, kt, vt, causal=causal)), _np(got))
    assert fa.flash_attention.launches == before


def test_flash_attention_plain_long_context():
    """test_kernels.py:91-97: 256 queries over 1024 keys, bottom-right causal."""
    rng = np.random.default_rng(7)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, s, "f32") for s in ((2, 256, 128), (2, 1024, 128), (2, 1024, 128))
    )
    want = jax_flash_attention(qj, kj, vj, causal=True, interpret=True)
    got = fa.flash_attention_plain(qt, kt, vt, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "hq,hk,sq,sk,d,causal",
    [(4, 2, 100, 100, 64, True), (6, 3, 37, 130, 32, True), (2, 1, 77, 45, 128, False),
     (32, 2, 1, 9, 128, True), (4, 4, 65, 65, 256, True)],
)
def test_flash_attention_plain_ragged_matches_ref(hq, hk, sq, sk, d, causal, dtype):
    """Lengths no block divides (the Pallas kernel refuses them; the CUDA
    kernel masks them) against the jnp oracle."""
    rng = np.random.default_rng(sq * 7 + sk)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, s, dtype) for s in ((hq, sq, d), (hk, sk, d), (hk, sk, d))
    )
    want = flash_attention_ref(qj, kj, vj, causal=causal)
    got = fa.flash_attention_plain(qt, kt, vt, causal=causal)
    tol = 3e-2 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_flash_attention_batched_views_equal_per_batch():
    """The model's call: (B, S, H, d) projections as transpose(1, 2) views,
    one call for the batch, equal to one 3-D call per sequence."""
    rng = np.random.default_rng(3)
    B, S, hq, hk, d = 3, 40, 8, 2, 32
    q = torch.from_numpy(rng.standard_normal((B, S, hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, hk, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, hk, d)).astype(np.float32))
    out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert out.shape == (B, hq, S, d)
    for b in range(B):
        want = fa.flash_attention_plain(
            q[b].transpose(0, 1).contiguous(), k[b].transpose(0, 1).contiguous(),
            v[b].transpose(0, 1).contiguous(),
        )
        torch.testing.assert_close(out[b], want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "q_shape,k_shape,kwargs,match",
    [
        ((4, 20, 32), (2, 10, 32), {}, "sq 20 > sk 10"),
        ((4, 8, 320), (2, 8, 320), {}, "head dim 320"),
        ((3, 8, 32), (2, 8, 32), {}, "hq % hk"),
        ((2, 4, 8, 32), (3, 2, 8, 32), {}, "batch sizes differ"),
        ((4, 8, 32), (2, 8, 32), {"k_dtype": torch.bfloat16}, "float32 or all bfloat16"),
        ((4, 8, 32), (2, 8, 32), {"dtype": torch.float64}, "float32 or all bfloat16"),
    ],
)
def test_flash_attention_refusals(q_shape, k_shape, kwargs, match):
    dt = kwargs.get("dtype", torch.float32)
    q = torch.zeros(q_shape, dtype=dt)
    k = torch.zeros(k_shape, dtype=kwargs.get("k_dtype", dt))
    v = torch.zeros(k_shape, dtype=kwargs.get("k_dtype", dt))
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, v)


def test_flash_attention_refuses_strided_head_dim():
    q = torch.zeros((4, 8, 64))[..., ::2]
    k = torch.zeros((2, 8, 32))
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention(q, k, k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "hq,hk,s,d,length",
    [(8, 2, 512, 128, 512), (4, 1, 1024, 128, 700), (16, 16, 256, 128, 256)],
)
def test_flash_decode_plain_matches_pallas(hq, hk, s, d, length, dtype):
    """test_kernels.py:103-126's sweep and tolerances."""
    B = 2
    rng = np.random.default_rng(hq + s + length)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, sh, dtype) for sh in ((B, hq, d), (B, s, hk, d), (B, s, hk, d))
    )
    want = jax_flash_decode(qj, kj, vj, length, bk=256, interpret=True)
    got = fd.flash_decode_plain(qt, kt, vt, length)
    assert got.dtype == TDT[dtype] and got.shape == (B, hq, d)
    tol = 3e-2 if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    before = fd.flash_decode.launches
    np.testing.assert_array_equal(_np(fd.flash_decode(qt, kt, vt, length)), _np(got))
    assert fd.flash_decode.launches == before


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "B,hq,hk,s,d,length",
    [(4, 32, 2, 96, 128, 65), (2, 4, 2, 300, 32, 171), (3, 16, 16, 50, 256, 1),
     (1, 8, 1, 33, 64, 33)],
)
def test_flash_decode_plain_ragged_matches_ref(B, hq, hk, s, d, length, dtype):
    """Cache lengths no block divides, and chatglm3-6b's group of 16."""
    rng = np.random.default_rng(s + length)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, sh, dtype) for sh in ((B, hq, d), (B, s, hk, d), (B, s, hk, d))
    )
    want = flash_decode_ref(qj, kj, vj, length)
    got = fd.flash_decode_plain(qt, kt, vt, length)
    tol = 3e-2 if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "q_shape,k_shape,length,match",
    [
        ((2, 8, 32), (2, 16, 2, 32), 0, "length 0 outside"),
        ((2, 8, 32), (2, 16, 2, 32), 17, "length 17 outside"),
        ((2, 6, 32), (2, 16, 4, 32), 4, "Hq % Hkv"),
        ((2, 8, 32), (3, 16, 2, 32), 4, "one batch"),
        ((2, 128, 256), (2, 16, 1, 256), 4, "shared memory"),
        ((2, 8), (2, 16, 2, 32), 4, "need q"),
    ],
)
def test_flash_decode_refusals(q_shape, k_shape, length, match):
    q, k = torch.zeros(q_shape), torch.zeros(k_shape)
    with pytest.raises(ValueError, match=match):
        fd.flash_decode(q, k, k, length)


def test_flash_decode_smem_formula_fits_chatglm():
    """chatglm3-6b's block (group 16, hd 128) and gemma-7b's (1, 256) fit."""
    assert fd.smem_bytes(16, 128) == 4 * (2 * 16 * 128 + 32 * 129 + 32 * 128 + 16 * 32 + 48)
    assert fd.smem_bytes(16, 128) <= fd.MAX_SMEM_BYTES
    assert fd.smem_bytes(1, 256) <= fd.MAX_SMEM_BYTES
