"""The port's transfer fold (repro_torch.kernels.sched_score) against the
reference's three forms: both plain PyTorch versions are bit-equal to
``transfer_matrix_jnp``, ``transfer_matrix_from_full`` and
``transfer_matrix_pallas(interpret=True)`` in f64, the wrapper takes the
plain version on CPU tensors and validates its inputs (the CUDA kernel
itself is held against the plain versions in test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sched_score as ref
from repro_torch.kernels import sched_score as port
from test_torch_cuda import FULL_CASES, full_case as _full_case


@pytest.mark.parametrize("case", FULL_CASES, ids=lambda c: f"seed{c[0]}-n{c[1]}-r{c[2]}-u{len(c[3])}")
def test_full_mask_fold_bit_equal_reference(case):
    masks, per_read, mem_shift, host_col = _full_case(*case)
    with jax.enable_x64(True):
        want = np.asarray(ref.transfer_matrix_from_full(
            jnp.asarray(masks), jnp.asarray(per_read),
            jnp.asarray(mem_shift), jnp.asarray(host_col),
        ))
        compact = port.compact_masks(
            torch.from_numpy(masks), torch.from_numpy(mem_shift)
        ).numpy()
        col_bits = np.asarray([1 << (u + 1) for u in range(len(mem_shift))], dtype=np.int32)
        want_pallas = np.asarray(ref.transfer_matrix_pallas(
            jnp.asarray(compact), jnp.asarray(per_read),
            jnp.asarray(col_bits), jnp.asarray(host_col), interpret=True,
        ))
    assert want.dtype == np.float64
    args = [torch.from_numpy(a) for a in (masks, per_read, mem_shift, host_col)]
    got_full = port.transfer_matrix_from_full(*args).numpy()
    got_wrapper = port.transfer_matrix(*args).numpy()
    got_compact = port.transfer_matrix_compact(
        torch.from_numpy(compact), args[1], torch.from_numpy(col_bits), args[3]
    ).numpy()
    assert (got_full == want).all()
    assert (got_wrapper == want).all()
    assert (got_compact == want).all()
    assert (want_pallas == want).all()
    assert not np.signbit(got_full).any()  # +0.0 stays +0.0


@pytest.mark.parametrize("n_pad,r_pad,n_u", [(256, 4, 25), (64, 2, 9)])
def test_compact_fold_bit_equal_jnp_and_pallas(n_pad, r_pad, n_u):
    """The reference's own inputs (test_backend.py): random compact codes,
    random per-read times, host at column 0."""
    rng = np.random.default_rng(0)
    masks = rng.integers(0, 1 << (n_u + 1), size=(n_pad, r_pad)).astype(np.int32)
    per_read = rng.random((n_pad, r_pad))
    col_bits = np.asarray([1 << (u + 1) for u in range(n_u)], dtype=np.int32)
    host_col = np.zeros(n_u, dtype=bool)
    host_col[0] = True
    with jax.enable_x64(True):
        j_args = [jnp.asarray(a) for a in (masks, per_read, col_bits, host_col)]
        a = np.asarray(ref.transfer_matrix_jnp(*j_args))
        b = np.asarray(ref.transfer_matrix_pallas(*j_args, interpret=True))
    got = port.transfer_matrix_compact(
        *[torch.from_numpy(x) for x in (masks, per_read, col_bits, host_col)]
    ).numpy()
    assert a.dtype == np.float64
    assert (got == a).all()
    assert (got == b).all()


def test_compact_masks_matches_reference_compaction():
    from repro.core.backend import _compact_masks_jnp

    masks, _, mem_shift, _ = _full_case(*FULL_CASES[2])
    with jax.enable_x64(True):
        want = np.asarray(_compact_masks_jnp(jnp, jnp.asarray(masks), jnp.asarray(mem_shift)))
    got = port.compact_masks(torch.from_numpy(masks), torch.from_numpy(mem_shift)).numpy()
    assert got.dtype == np.int32
    assert (got == want).all()


@pytest.mark.parametrize(
    "bad",
    ["masks_dtype", "per_read_dtype", "per_read_shape", "shift_dtype",
     "host_dtype", "host_shape", "noncontiguous"],
)
def test_wrapper_rejects_malformed_inputs(bad):
    masks, per_read, mem_shift, host_col = [
        torch.from_numpy(a) for a in _full_case(*FULL_CASES[0])
    ]
    if bad == "masks_dtype":
        masks = masks.to(torch.int32)
    elif bad == "per_read_dtype":
        per_read = per_read.to(torch.float32)
    elif bad == "per_read_shape":
        per_read = per_read[:, :2].contiguous()
    elif bad == "shift_dtype":
        mem_shift = mem_shift.to(torch.int32)
    elif bad == "host_dtype":
        host_col = host_col.to(torch.uint8)
    elif bad == "host_shape":
        host_col = host_col[:-1]
    else:
        masks = masks.t().contiguous().t()
        per_read = per_read.t().contiguous().t()
    with pytest.raises(ValueError):
        port.transfer_matrix(masks, per_read, mem_shift, host_col)


def test_wrapper_on_cpu_launches_nothing():
    before = port.transfer_matrix.launches
    port.transfer_matrix(*[torch.from_numpy(a) for a in _full_case(*FULL_CASES[3])])
    assert port.transfer_matrix.launches == before
