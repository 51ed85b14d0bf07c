"""The port's ``gemm_update`` / ``matmul`` against the reference's.

On CPU tensors the wrapper runs its plain version; it is held here against
JAX's Pallas ``gemm_update`` in interpret mode and against the jnp oracle
``repro.kernels.ref.gemm_update_ref``, over the shapes, types and
alpha / trans_b cases of ``tests/test_kernels.py`` at its ``TOL``
(atol = TOL * sqrt(k), rtol = TOL). Inputs are seeded numpy f32 arrays;
bf16 inputs are the same arrays cast on each side (both round to nearest
even, so both packages get the same bits). The wrapper's refusals follow
the reference's. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import gemm_update_ref, matmul_ref
from repro.kernels.tile_gemm import gemm_update as jax_gemm_update
from repro.kernels.tile_gemm import matmul as jax_matmul
from repro_torch.kernels import tile_gemm as port

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 2e-4, "bf16": 5e-2}  # tests/test_kernels.py:21


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype, k):
    np.testing.assert_allclose(
        _f32(got), _f32(want), atol=TOL[dtype] * k ** 0.5, rtol=TOL[dtype]
    )


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 128, 384), (384, 256, 128), (64, 64, 64)])
def test_gemm_update_matches_interpret_kernel(m, n, k, dtype):
    rng = np.random.default_rng(m * 7 + n * 3 + k)
    (jc, tc), (ja, ta), (jb, tb) = (_pair(rng, s, dtype) for s in ((m, n), (m, k), (k, n)))
    np.testing.assert_array_equal(_f32(tc), _f32(jc))  # same bits on both sides
    got = port.gemm_update(tc, ta, tb)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    _close(got, jax_gemm_update(jc, ja, jb, interpret=True), dtype, k)
    _close(got, gemm_update_ref(jc, ja, jb), dtype, k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("alpha", [-1.0, 1.0, 0.5])
@pytest.mark.parametrize("trans_b", [False, True])
def test_gemm_update_variants(alpha, trans_b, dtype):
    m, n, k = 256, 128, 128
    rng = np.random.default_rng(int(alpha * 4) + 4 + 10 * trans_b)
    jc, tc = _pair(rng, (m, n), dtype)
    ja, ta = _pair(rng, (m, k), dtype)
    jb, tb = _pair(rng, (n, k) if trans_b else (k, n), dtype)
    got = port.gemm_update(tc, ta, tb, alpha=alpha, trans_b=trans_b)
    _close(got, jax_gemm_update(jc, ja, jb, alpha=alpha, trans_b=trans_b, interpret=True), dtype, k)
    _close(got, gemm_update_ref(jc, ja, jb, alpha=alpha, trans_b=trans_b), dtype, k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matmul(dtype):
    rng = np.random.default_rng(5)
    ja, ta = _pair(rng, (256, 384), dtype)
    jb, tb = _pair(rng, (384, 128), dtype)
    got = port.matmul(ta, tb)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, jax_matmul(ja, jb, interpret=True), dtype, 384)
    _close(got, matmul_ref(ja, jb), dtype, 384)
    _close(port.matmul_plain(ta, tb), matmul_ref(ja, jb), dtype, 384)


def test_plain_version_is_the_oracle_in_torch():
    """gemm_update_plain is ref.gemm_update_ref: f32 product, f32 sum, one
    cast to C's dtype at the end."""
    rng = np.random.default_rng(9)
    jc, tc = _pair(rng, (64, 128), "bf16")
    ja, ta = _pair(rng, (64, 32), "bf16")
    jb, tb = _pair(rng, (128, 32), "bf16")
    got = port.gemm_update_plain(tc, ta, tb, alpha=0.5, trans_b=True)
    want = tc.float() + 0.5 * (ta.float() @ tb.float().T)
    assert torch.equal(got, want.to(torch.bfloat16))
    _close(got, gemm_update_ref(jc, ja, jb, alpha=0.5, trans_b=True), "bf16", 32)


def test_strided_views_and_a_new_result():
    """Operands may be views with a row stride above their width (tiles
    of a whole matrix); the result is a new tensor and C is left as it
    was."""
    rng = np.random.default_rng(11)
    whole = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    c, a, b = whole[:128, :128], whole[128:, :64], whole[:64, 128:]
    c_before = c.clone()
    got = port.gemm_update(c, a, b, alpha=-1.0)
    want = port.gemm_update(c.contiguous(), a.contiguous(), b.contiguous(), alpha=-1.0)
    assert torch.equal(got, want)
    assert torch.equal(c, c_before)
    assert got.data_ptr() != c.data_ptr() and got.is_contiguous()


def _refused(**kw):
    base = dict(
        c=torch.zeros(128, 128), a=torch.zeros(128, 64), b=torch.zeros(64, 128)
    )
    base.update(kw)
    c, a, b = base.pop("c"), base.pop("a"), base.pop("b")
    return lambda: port.gemm_update(c, a, b, **base)


@pytest.mark.parametrize(
    "case,match",
    [
        # test_kernels.py:62 — the reference's non-tiling refusal
        (dict(c=torch.zeros(100, 100), a=torch.zeros(100, 100), b=torch.zeros(100, 100),
              bm=64, bn=64, bk=64), "tile evenly"),
        (dict(c=torch.zeros(128, 128, dtype=torch.float64), a=torch.zeros(128, 64, dtype=torch.float64),
              b=torch.zeros(64, 128, dtype=torch.float64)), "float32"),
        (dict(a=torch.zeros(128, 64, dtype=torch.bfloat16)), "float32"),
        (dict(b=torch.zeros(128, 64)), "chain"),
        (dict(trans_b=True), "chain"),
        (dict(a=torch.zeros(64, 128).T), "unit column stride"),
        (dict(c=torch.zeros(128)), "2-D"),
    ],
    ids=["non-tiling", "f64", "mixed-dtypes", "shape", "trans-shape", "column-major", "1-D"],
)
def test_gemm_update_refusals(case, match):
    with pytest.raises(ValueError, match=match):
        _refused(**case)()


def test_f64_is_refused_before_any_device_dispatch(monkeypatch):
    """An f64 tensor is refused by the checks, never handed to a plain
    version or a kernel: on a CUDA tensor, too, it raises."""
    def boom(*args, **kwargs):
        raise AssertionError("reached a compute path")

    monkeypatch.setattr(port, "gemm_update_plain", boom)
    monkeypatch.setattr(port, "build", boom)
    c = torch.zeros(64, 64, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        port.gemm_update(c, c, c)


def test_cpu_tensors_never_launch():
    before = port.gemm_update.launches
    x = torch.ones(64, 64)
    port.gemm_update(x, x, x)
    port.matmul(x, x)
    assert port.gemm_update.launches == before


def test_other_devices_are_refused():
    x = torch.zeros(64, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.gemm_update(x, x, x)


# ---------------------------------------------------------------------------
# the kernel's launch plan and its split-K arithmetic (no card needed)

# syrk / gemm / ssssm / ormqr, and tsmqr
MAIN_PATH_SHAPES = [(512, 512, 512), (1024, 512, 1024)]


@pytest.mark.parametrize("k", [1, 16, 64, 100, 128, 256, 384, 512, 528, 1024, 4096])
@pytest.mark.parametrize("m,n", [(64, 64), (100, 72), (128, 128), (512, 512), (1024, 512), (4096, 4096)])
def test_gemm_plan_invariants(m, n, k):
    """Every k covered once by non-empty chunks of whole stages, chunks cut
    as the split plain version cuts them, at most two blocks per SM once k
    is split, and the same plan for every call."""
    plans = {port.gemm_plan(m, n, k) for _ in range(2)}
    assert len(plans) == 1
    bm, bn, n_split, k_chunk = plans.pop()
    assert (bm, bn) == port.TILE
    assert k_chunk % port.STAGE_K == 0 and k_chunk > 0
    assert k_chunk == port.split_chunk(k, n_split)
    starts = range(0, n_split * k_chunk, k_chunk)
    covered = [kk for s in starts for kk in range(s, min(k, s + k_chunk))]
    assert covered == list(range(k))  # each k once, in order, no empty split
    assert all(s < k for s in starts)
    if n_split > 1:
        assert k_chunk >= port.MIN_K_CHUNK
        assert -(-m // bm) * -(-n // bn) * n_split <= 2 * port.N_SM


@pytest.mark.parametrize("m,n,k", MAIN_PATH_SHAPES)
def test_gemm_plan_fills_the_card_at_the_main_path_shapes(m, n, k):
    """syrk / gemm / ssssm / ormqr (512^3) and tsmqr (1024 x 512 x 1024):
    one to two waves of the 132 SMs."""
    bm, bn, n_split, k_chunk = port.gemm_plan(m, n, k)
    blocks = -(-m // bm) * -(-n // bn) * n_split
    assert 128 <= blocks <= 264
    assert n_split > 1


@pytest.mark.parametrize("m,n,n_split,want", [(512, 512, 1, 0), (512, 512, 4, 4 * 512 * 512),
                                              (1024, 512, 2, 2 * 1024 * 512), (100, 72, 3, 3 * 7200)])
def test_workspace_elems(m, n, n_split, want):
    """One f32 (m, n) partial per split, none without a split."""
    assert port.workspace_elems(m, n, n_split) == want


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("m,n,k", [(64, 64, 256), (256, 128, 384), (128, 128, 512)])
def test_split_plain_at_the_planner_splits_matches_reference(m, n, k, trans_b, dtype):
    """The split-then-combine arithmetic at the planner's split count is
    within the reference's TOL of its interpret-mode kernel and oracle."""
    n_split = port.gemm_plan(m, n, k)[2]
    assert n_split > 1
    rng = np.random.default_rng(m + n + k + trans_b)
    jc, tc = _pair(rng, (m, n), dtype)
    ja, ta = _pair(rng, (m, k), dtype)
    jb, tb = _pair(rng, (n, k) if trans_b else (k, n), dtype)
    got = port.gemm_update_split_plain(tc, ta, tb, alpha=-1.0, trans_b=trans_b, n_split=n_split)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    _close(got, jax_gemm_update(jc, ja, jb, alpha=-1.0, trans_b=trans_b, interpret=True), dtype, k)
    _close(got, gemm_update_ref(jc, ja, jb, alpha=-1.0, trans_b=trans_b), dtype, k)


def test_split_plain_sums_the_partials_in_split_order():
    """One split is the plain version bit for bit; more splits are the
    per-chunk f32 products summed 0, 1, .., S - 1 before C enters."""
    rng = np.random.default_rng(3)
    c, a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((32, 48), (32, 528), (528, 48)))
    assert torch.equal(port.gemm_update_split_plain(c, a, b, alpha=0.5, n_split=1),
                       port.gemm_update_plain(c, a, b, alpha=0.5))
    kc = port.split_chunk(528, 3)
    parts = [a[:, s:s + kc] @ b[s:s + kc] for s in range(0, 528, kc)]
    want = c + 0.5 * ((parts[0] + parts[1]) + parts[2])
    assert torch.equal(port.gemm_update_split_plain(c, a, b, alpha=0.5, n_split=3), want)


def test_split_plain_refuses_an_empty_split():
    x = torch.zeros(16, 32)
    with pytest.raises(ValueError, match="non-empty splits"):
        port.gemm_update_split_plain(torch.zeros(16, 16), x, x, trans_b=True, n_split=3)


def test_matmul_takes_no_c_and_counts_nothing_on_the_cpu():
    """matmul hands gemm_update a None C; on the CPU that is a zero C, so
    its result is the plain version's with C = 0."""
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((64, 96), (96, 32)))
    before = (port.gemm_update.launches, port.gemm_update.launches_split)
    got = port.gemm_update(None, a, b, alpha=1.0)
    assert torch.equal(got, port.gemm_update_plain(torch.zeros(64, 32), a, b, alpha=1.0))
    assert torch.equal(port.matmul(a, b), got)
    assert (port.gemm_update.launches, port.gemm_update.launches_split) == before
