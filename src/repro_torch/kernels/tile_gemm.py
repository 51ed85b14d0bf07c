"""Tile GEMM update ``C + alpha * A @ op(B)``: CUDA kernel + plain versions.

The compute hot spot of the PLASMA tile bodies the paper schedules: gemm,
syrk, ssssm, ormqr and tsmqr are all GEMM-shaped updates.

Counterpart of ``repro/kernels/tile_gemm.py`` and its oracles in
``repro/kernels/ref.py``:

  * :func:`gemm_update_plain` / :func:`matmul_plain` — ``gemm_update_ref``
    and ``matmul_ref`` in torch: the product taken in f32, added to C in
    f32, cast to C's dtype;
  * :func:`gemm_update` — the wrapper of the hand-written CUDA kernel
    ``csrc/tile_gemm.cu`` that replaces the Pallas ``gemm_update``
    (``repro/kernels/tile_gemm.py:53``); :func:`matmul` goes through it
    with C = 0 and alpha = +1, as the reference's does. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises.

The wrapper refuses what the reference refuses: with ``bm = min(bm, m)``
(and ``bn``, ``bk`` alike) the block sizes must divide m, n and k. The
kernel's own tile (64 x 64 x 16) is independent of them. Types are f32 or
bf16, all three operands alike; an f64 tensor raises on every device (the
reference executes f32). Each operand needs a unit column stride; its row
stride may exceed its width, so tiles that are views of a whole matrix go
in without a copy. The result is always a new tensor.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ._build import build_library

_SRC = Path(__file__).resolve().parent / "csrc" / "tile_gemm.cu"
SOURCES = (_SRC,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def gemm_update_plain(c, a, b, *, alpha: float = -1.0, trans_b: bool = False):
    """``C + alpha * A @ op(B)`` with f32 products and sum, cast to C's dtype."""
    bb = b.T if trans_b else b
    acc = c.float() + alpha * (a.float() @ bb.float())
    return acc.to(c.dtype)


def matmul_plain(a, b):
    """``A @ B`` with an f32 product, cast to A's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


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
    fn = lib.repro_gemm_update
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    _lib = lib
    return _build_log


def _check(c, a, b, trans_b, bm, bn, bk):
    for name, t in (("c", c), ("a", a), ("b", b)):
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    m, k = a.shape
    n, kb = b.shape if trans_b else (b.shape[1], b.shape[0])
    if kb != k or tuple(c.shape) != (m, n):
        raise ValueError(
            f"shapes do not chain: c {tuple(c.shape)}, a {tuple(a.shape)}, "
            f"b {tuple(b.shape)}, trans_b={trans_b}"
        )
    if min(m, n, k) <= 0:
        raise ValueError(f"empty product: (m, n, k) = {(m, n, k)}")
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if min(bm, bn, bk) <= 0 or m % bm or n % bn or k % bk:
        raise ValueError(
            f"shapes must tile evenly: (m, n, k) = {(m, n, k)}, blocks {(bm, bn, bk)}"
        )
    if c.dtype not in _DTYPE_CODE or a.dtype != c.dtype or b.dtype != c.dtype:
        raise ValueError(
            f"c, a and b must all be float32 or all bfloat16, got "
            f"{c.dtype}, {a.dtype}, {b.dtype}"
        )
    devices = {t.device for t in (c, a, b)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    for name, t in (("c", c), ("a", a), ("b", b)):
        rows, cols = t.shape
        if (cols > 1 and t.stride(1) != 1) or (rows > 1 and t.stride(0) < cols):
            raise ValueError(
                f"{name} must be row-major with unit column stride, got strides {t.stride()}"
            )
    return m, n, k


def gemm_update(
    c: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    alpha: float = -1.0,
    trans_b: bool = False,
    bm: int = 128,
    bn: int = 128,
    bk: int = 128,
) -> torch.Tensor:
    """``C + alpha * A @ B`` (or ``A @ B.T`` when ``trans_b``) as a new
    tensor: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors. ``gemm_update.launches`` counts the kernel launches."""
    m, n, k = _check(c, a, b, trans_b, bm, bn, bk)
    dev = c.device
    if dev.type == "cpu":
        return gemm_update_plain(c, a, b, alpha=alpha, trans_b=trans_b)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    build()
    out = torch.empty((m, n), dtype=c.dtype, device=dev)
    err = _lib.repro_gemm_update(
        c.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        c.stride(0), a.stride(0), b.stride(0), float(alpha), int(bool(trans_b)),
        _DTYPE_CODE[c.dtype], dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gemm_update kernel launch failed: CUDA error {err}")
    gemm_update.launches += 1
    return out


gemm_update.launches = 0


def matmul(
    a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128, bk: int = 128
) -> torch.Tensor:
    """Plain ``A @ B`` through the same kernel (C = 0, alpha = +1)."""
    c0 = torch.zeros((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
    return gemm_update(c0, a, b, alpha=1.0, trans_b=False, bm=bm, bn=bn, bk=bk)
