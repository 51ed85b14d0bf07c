"""Transfer-time fold of the placement scorer: CUDA kernel + plain versions.

For every (ready task i, memory space u) pair, sum the per-read transfer
times of the reads that are not resident at u:

    X[i, u] = Σ_r  hops(mask[i, r], u) * per_read[i, r]

``hops`` is the paper-era PCIe path length: 0 if resident (or the data
exists nowhere yet), 1 to the host or when a host copy exists, 2 for
device→host→device. The fold over ``r`` runs in order from +0.0, so every
entry is bit-equal to ``repro``'s numpy rows; padded reads carry mask 0
and per-read time 0 and add an exact +0.0.

Counterpart of ``repro/kernels/sched_score.py``:

  * :func:`transfer_matrix_compact` — plain version of
    ``transfer_matrix_jnp`` (int32 compact codes: bit 0 host, bit u+1
    unique memory u);
  * :func:`transfer_matrix_from_full` — plain version of
    ``transfer_matrix_from_full`` (int64 full residency masks and the
    per-column shift ``mem+1``);
  * :func:`transfer_matrix` — the wrapper of the hand-written CUDA kernel
    ``csrc/sched_score.cu`` that replaces ``transfer_matrix_pallas``
    (``repro/kernels/sched_score.py:121``). It reads the full masks, so
    no compaction pass runs. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises.

f64 throughout: the H100 has native f64, so the f32 relaxation the
reference notes for TPUs does not apply. The kernel is built with ``nvcc``
at first use into ``build/repro_torch_kernels/`` and loaded with ctypes
(:mod:`._build`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Optional

import torch

from ._build import NVCC_FLAGS, build_library  # noqa: F401  (NVCC_FLAGS: this kernel's flags)

_SRC = Path(__file__).resolve().parent / "csrc" / "sched_score.cu"
SOURCES = (_SRC,)


def _hop_fold(
    masks: torch.Tensor,
    per_read: torch.Tensor,
    resident_of: Callable[[int], torch.Tensor],
    host_col: torch.Tensor,
) -> torch.Tensor:
    """The in-order read fold shared by both plain versions.

    ``resident_of(r)`` gives the (n, n_u) residency booleans of read
    column ``r``; the hop formula lives here once.
    """
    on_host = (masks & 1) != 0
    nowhere = masks == 0
    acc = torch.zeros(
        (masks.shape[0], host_col.shape[0]),
        dtype=per_read.dtype, device=per_read.device,
    )
    for r in range(masks.shape[1]):
        skip = resident_of(r) | nowhere[:, r, None]
        hops = torch.where(
            host_col[None, :] | on_host[:, r, None], 1.0, 2.0
        ).to(per_read.dtype).masked_fill(skip, 0.0)
        acc = acc + hops * per_read[:, r, None]
    return acc


def transfer_matrix_compact(
    masks: torch.Tensor,  # (n, r) int32 compact residency codes
    per_read: torch.Tensor,  # (n, r) f64 per-read transfer times
    col_bits: torch.Tensor,  # (n_u,) int32, bit u+1 set
    host_col: torch.Tensor,  # (n_u,) bool, True where unique mem u is the host
) -> torch.Tensor:
    """Plain fold over compact codes: (n × n_u) transfer times."""
    return _hop_fold(
        masks, per_read,
        lambda r: (masks[:, r, None] & col_bits[None, :]) != 0,
        host_col,
    )


def transfer_matrix_from_full(
    masks: torch.Tensor,  # (n, r) int64 full residency masks
    per_read: torch.Tensor,  # (n, r) f64 per-read transfer times
    mem_shift: torch.Tensor,  # (n_u,) int64, mem+1 per unique memory
    host_col: torch.Tensor,  # (n_u,) bool, True where unique mem u is the host
) -> torch.Tensor:
    """Plain fold straight off the full int64 residency masks."""
    return _hop_fold(
        masks, per_read,
        lambda r: ((masks[:, r, None] >> mem_shift[None, :]) & 1) != 0,
        host_col,
    )


def compact_masks(full_masks: torch.Tensor, mem_shift: torch.Tensor) -> torch.Tensor:
    """int32 compact codes from full int64 masks: bit 0 = host copy, bit
    u+1 = a valid copy at unique memory u (the input of the compact form)."""
    out = (full_masks & 1).to(torch.int32)
    for u in range(mem_shift.shape[0]):
        bit = ((full_masks >> mem_shift[u]) & 1).to(torch.int32)
        out = out | (bit << (u + 1))
    return out


# ---------------------------------------------------------------------------
# the CUDA kernel

_lib: Optional[ctypes.CDLL] = None
_build_log = ""


def build() -> str:
    """Build (or reuse) the kernel library from the repo's source and load
    it; returns the compiler's resource report (``-Xptxas -v``)."""
    global _lib, _build_log
    if _lib is not None:
        return _build_log
    lib, _build_log = build_library(_SRC)
    fn = lib.repro_transfer_matrix
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return _build_log


def _check(masks, per_read, mem_shift, host_col) -> None:
    if masks.dtype != torch.int64 or masks.dim() != 2:
        raise ValueError(f"masks must be 2-D int64, got {masks.dtype} {tuple(masks.shape)}")
    if per_read.dtype != torch.float64 or per_read.shape != masks.shape:
        raise ValueError(
            f"per_read must be f64 of shape {tuple(masks.shape)}, got "
            f"{per_read.dtype} {tuple(per_read.shape)}"
        )
    if mem_shift.dtype != torch.int64 or mem_shift.dim() != 1:
        raise ValueError(f"mem_shift must be 1-D int64, got {mem_shift.dtype}")
    if host_col.dtype != torch.bool or host_col.shape != mem_shift.shape:
        raise ValueError(
            f"host_col must be bool of shape {tuple(mem_shift.shape)}, got "
            f"{host_col.dtype} {tuple(host_col.shape)}"
        )
    devices = {t.device for t in (masks, per_read, mem_shift, host_col)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if not all(t.is_contiguous() for t in (masks, per_read, mem_shift, host_col)):
        raise ValueError("inputs must be contiguous")


def transfer_matrix(
    masks: torch.Tensor,  # (n, r) int64 full residency masks
    per_read: torch.Tensor,  # (n, r) f64 per-read transfer times
    mem_shift: torch.Tensor,  # (n_u,) int64, mem+1 per unique memory (0..62)
    host_col: torch.Tensor,  # (n_u,) bool
) -> torch.Tensor:
    """(n × n_u) f64 transfer times: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. ``transfer_matrix.launches`` counts the
    kernel launches."""
    _check(masks, per_read, mem_shift, host_col)
    dev = masks.device
    if dev.type == "cpu":
        return transfer_matrix_from_full(masks, per_read, mem_shift, host_col)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    build()
    n, r = masks.shape
    n_u = mem_shift.shape[0]
    out = torch.empty((n, n_u), dtype=torch.float64, device=dev)
    if n * n_u == 0:
        return out
    err = _lib.repro_transfer_matrix(
        masks.data_ptr(), per_read.data_ptr(), mem_shift.data_ptr(),
        host_col.data_ptr(), out.data_ptr(), n, r, n_u, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"transfer_matrix kernel launch failed: CUDA error {err}")
    transfer_matrix.launches += 1
    return out


transfer_matrix.launches = 0
