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


# ---------------------------------------------------------------------------
# the tensor-core routes' host side: the split planner, the route rules,
# and the split-then-combine arithmetic


@pytest.mark.parametrize("batch", [1, 2, 4, 16, 64])
@pytest.mark.parametrize("hkv", [1, 2, 8])
@pytest.mark.parametrize("length", [1, 63, 64, 65, 96, 700, 4097, 32768])
def test_decode_splits_cover_every_position_once(batch, hkv, length):
    chunk, n_split = fd.decode_splits(batch, hkv, length)
    assert chunk % fd.TILE == 0 and chunk > 0
    tiles = chunk // fd.TILE
    assert tiles & (tiles - 1) == 0  # a power of two
    starts = range(0, n_split * chunk, chunk)
    covered = [p for s in starts for p in range(s, min(s + chunk, length))]
    assert covered == list(range(length))  # every position in exactly one split
    assert all(s < length for s in starts)  # no split is empty
    # about two blocks per SM where the length allows it, never one tile more
    if n_split * batch * hkv < 2 * fd.N_SM:
        assert chunk == fd.TILE


def test_decode_splits_at_the_serving_shapes():
    """chatglm3-6b: the serving step (B 4, 2 KV heads, cache 96) and the
    decode_32k-like shape (B 16, S 32 768)."""
    assert fd.decode_splits(4, 2, 96) == (64, 2)  # 16 blocks
    chunk, n_split = fd.decode_splits(16, 2, 32768)
    assert (chunk, n_split) == (2048, 16) and n_split * 16 * 2 == 512
    with pytest.raises(ValueError, match="positive"):
        fd.decode_splits(4, 2, 0)


def _t(shape, dtype=torch.bfloat16, offset=0, width=None):
    """A CPU tensor of ``shape`` whose last dim is cut from rows of
    ``width`` starting ``offset`` elements in (alignment and strides)."""
    width = width or shape[-1]
    base = torch.zeros((*shape[:-1], width + offset), dtype=dtype)
    return base[..., offset:offset + shape[-1]]


@pytest.mark.parametrize(
    "q,k,route",
    [
        (_t((4, 256, 2, 128)).transpose(1, 2), _t((4, 256, 2, 128)).transpose(1, 2), "tc"),
        (_t((32, 100, 64)), _t((2, 100, 64)), "tc"),
        (_t((1, 32, 9, 128)), _t((1, 2, 9, 128)), "tc"),
        (_t((32, 100, 64), torch.float32), _t((2, 100, 64), torch.float32), "simt"),
        (_t((8, 64, 32)), _t((2, 64, 32)), "simt"),
        (_t((8, 64, 256)), _t((2, 64, 256)), "simt"),
        (_t((8, 64, 128), offset=1), _t((2, 64, 128)), "simt"),
        (_t((8, 64, 128)), _t((2, 64, 128), width=132), "simt"),
        (_t((2, 8, 64, 64)), _t((2, 2, 64, 64), width=68), "simt"),
    ],
    ids=["bshd-views", "3d-d64", "batch1", "f32", "d32", "d256", "unaligned-q",
         "seq-stride-132", "strided-k"],
)
def test_attention_route_rule(q, k, route):
    assert fa.attention_route(q, k, k) == route


def test_attention_route_batch_of_one_ignores_its_stride():
    q = torch.zeros((2, 8, 64, 64), dtype=torch.bfloat16)[:1]
    k = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16).as_strided((1, 2, 64, 64), (3, 4096, 64, 1))
    assert fa.attention_route(q, k, k) == "tc"


@pytest.mark.parametrize(
    "q,k,route",
    [
        (_t((4, 32, 128)), _t((4, 96, 2, 128)), "split"),
        (_t((4, 1, 4096))[:, 0].view(4, 32, 128), _t((4, 96, 2, 128)), "split"),
        (_t((2, 8, 64)), _t((2, 50, 8, 64)), "split"),
        (_t((2, 64, 256)), _t((2, 50, 2, 256)), "split"),
        (_t((2, 24, 16)), _t((2, 50, 1, 16)), "split"),
        (_t((4, 32, 128), torch.float32), _t((4, 96, 2, 128), torch.float32), "simt"),
        (_t((2, 64, 128)), _t((2, 50, 1, 128)), "simt"),
        (_t((2, 8, 24)), _t((2, 50, 2, 24)), "simt"),
        (_t((2, 8, 272)), _t((2, 50, 2, 272)), "simt"),
        (_t((4, 32, 128), offset=8), _t((4, 96, 2, 128)), "split"),
        (_t((4, 32, 128), offset=4), _t((4, 96, 2, 128)), "simt"),
        (_t((4, 32, 128)), _t((4, 96, 2, 128), width=132), "simt"),
    ],
    ids=["serving", "projection-view", "group4-hd64", "hd256", "group24-hd16", "f32",
         "group64", "hd24", "hd272", "aligned-offset", "unaligned-q", "row-stride-132"],
)
def test_decode_route_rule(q, k, route):
    assert fd.decode_route(q, k, k) == route


def test_split_smem_formula_fits_every_head_dim():
    assert fd.split_smem_bytes(128) == 2 * 136 * (16 + 6 * 64)
    assert all(fd.split_smem_bytes(hd) <= fd.MAX_SMEM_BYTES for hd in range(16, 257, 16))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "B,hq,hk,s,d,length",
    [(2, 8, 2, 512, 128, 512), (2, 4, 1, 1024, 128, 700), (4, 32, 2, 96, 128, 65),
     (3, 16, 16, 50, 256, 1), (2, 32, 1, 300, 64, 129), (1, 8, 1, 33, 64, 33)],
)
def test_flash_decode_split_plain_matches_reference(B, hq, hk, s, d, length, dtype):
    """The split-then-combine arithmetic at the planner's splits against the
    Pallas kernel (interpret mode) where it takes the shape and the ``ref.py``
    oracle everywhere: length 1, a last split of one position (65 and 129 at
    a chunk of 64) and ragged lengths."""
    rng = np.random.default_rng(s * 3 + length)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, sh, dtype) for sh in ((B, hq, d), (B, s, hk, d), (B, s, hk, d))
    )
    chunk, n_split = fd.decode_splits(B, hk, length)
    assert (n_split - 1) * chunk < length <= n_split * chunk
    got = fd.flash_decode_split_plain(qt, kt, vt, length)
    assert got.dtype == TDT[dtype] and got.shape == (B, hq, d)
    tol = 3e-2 if dtype == "bf16" else 1e-5
    wants = [flash_decode_ref(qj, kj, vj, length)]
    if s % 256 == 0:  # the Pallas kernel's own block (bk 256) must divide S
        wants.append(jax_flash_decode(qj, kj, vj, length, bk=256, interpret=True))
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
