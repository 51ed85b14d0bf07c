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
    with C = 0 and alpha = +1, as the reference's does (on the card the
    zero C is never made: the kernel reads a null C as zero). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises;
  * :func:`gemm_plan` — the kernel's launch plan, a pure function of the
    shape: block tile and split of k;
  * :func:`gemm_update_split_plain` — the kernel's split-K arithmetic in
    torch (per-split f32 partials summed in split order), for the tests.

The wrapper refuses what the reference refuses: with ``bm = min(bm, m)``
(and ``bn``, ``bk`` alike) the block sizes must divide m, n and k. The
kernel's own tiles are independent of them. Types are f32 or bf16, all
three operands alike; an f64 tensor raises on every device (the reference
executes f32). Each operand needs a unit column stride; its row stride may
exceed its width, so tiles that are views of a whole matrix go in without a
copy. The result is always a new tensor.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from ._build import build_library

_SRC = Path(__file__).resolve().parent / "csrc" / "tile_gemm.cu"
SOURCES = (_SRC,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

STAGE_K = 16  # k per shared-memory stage of the kernel (BK in csrc/tile_gemm.cu)
TILE = (64, 64)  # the kernel's block tile (rows, columns)
MIN_K_CHUNK = 128  # the shortest k-chunk the planner cuts a split to
N_SM = 132  # SMs of an H100 SXM


def gemm_update_plain(c, a, b, *, alpha: float = -1.0, trans_b: bool = False):
    """``C + alpha * A @ op(B)`` with f32 products and sum, cast to C's dtype."""
    bb = b.T if trans_b else b
    acc = c.float() + alpha * (a.float() @ bb.float())
    return acc.to(c.dtype)


def matmul_plain(a, b):
    """``A @ B`` with an f32 product, cast to A's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def split_chunk(k: int, n_split: int) -> int:
    """k per split when k is cut into ``n_split`` chunks of whole stages,
    as even as they go (the last may be shorter)."""
    return _cdiv(_cdiv(k, STAGE_K), n_split) * STAGE_K


def gemm_plan(m: int, n: int, k: int) -> Tuple[int, int, int, int]:
    """The kernel's plan ``(bm, bn, n_split, k_chunk)`` for an (m, n, k)
    call: block tile bm x bn (``TILE``), and k cut into ``n_split`` chunks
    of ``k_chunk`` (a multiple of ``STAGE_K``, none empty).

    A call gets as many splits as keep its grid within two blocks per SM
    (2 * ``N_SM``; two 128-thread blocks share an SM) and its chunks at
    least ``MIN_K_CHUNK`` long. A pure function of the shape: replays of a
    tile get one plan and the same bits, whatever the type or ``trans_b``."""
    bm, bn = TILE
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    want = max(1, min(2 * N_SM // tiles, k // MIN_K_CHUNK))
    n_split = _cdiv(k, split_chunk(k, want))
    return bm, bn, n_split, split_chunk(k, n_split)


def workspace_elems(m: int, n: int, n_split: int) -> int:
    """f32 elements of the split-K workspace: one (m, n) partial per split,
    none without a split."""
    return n_split * m * n if n_split > 1 else 0


def gemm_update_split_plain(c, a, b, *, alpha: float = -1.0, trans_b: bool = False, n_split: int = 1):
    """The kernel's split-K arithmetic in torch: k cut as the kernel cuts
    it (``split_chunk``), one f32 partial product per split, the partials
    summed in split order, then ``C + alpha * sum`` cast to C's dtype."""
    k = a.shape[1]
    k_chunk = split_chunk(k, n_split)
    if _cdiv(k, k_chunk) != n_split:
        raise ValueError(f"k = {k} cannot be cut into {n_split} non-empty splits of whole stages")
    af, bf = a.float(), (b.T if trans_b else b).float()
    acc = None
    for s in range(n_split):
        part = af[:, s * k_chunk:(s + 1) * k_chunk] @ bf[s * k_chunk:(s + 1) * k_chunk]
        acc = part if acc is None else acc + part
    return (c.float() + alpha * acc).to(c.dtype)


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
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
        + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    _lib = lib
    return _build_log


def _check(c, a, b, trans_b, bm, bn, bk):
    """Shapes, types, devices and strides; ``c`` may be None (matmul)."""
    named = ([("c", c)] if c is not None else []) + [("a", a), ("b", b)]
    for name, t in named:
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    m, k = a.shape
    n, kb = b.shape if trans_b else (b.shape[1], b.shape[0])
    if kb != k or (c is not None and tuple(c.shape) != (m, n)):
        raise ValueError(
            f"shapes do not chain: c {None if c is None else tuple(c.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}, trans_b={trans_b}"
        )
    if min(m, n, k) <= 0:
        raise ValueError(f"empty product: (m, n, k) = {(m, n, k)}")
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if min(bm, bn, bk) <= 0 or m % bm or n % bn or k % bk:
        raise ValueError(
            f"shapes must tile evenly: (m, n, k) = {(m, n, k)}, blocks {(bm, bn, bk)}"
        )
    dtypes = [t.dtype for _, t in named]
    if a.dtype not in _DTYPE_CODE or any(dt != a.dtype for dt in dtypes):
        raise ValueError(
            f"c, a and b must all be float32 or all bfloat16, got "
            f"{', '.join(str(dt) for dt in dtypes)}"
        )
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    for name, t in named:
        rows, cols = t.shape
        if (cols > 1 and t.stride(1) != 1) or (rows > 1 and t.stride(0) < cols):
            raise ValueError(
                f"{name} must be row-major with unit column stride, got strides {t.stride()}"
            )
    return m, n, k


def _launch(c, a, b, *, alpha: float, trans_b: bool, plan) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands under ``plan``; ``c`` may
    be None (read as zero)."""
    m, k = a.shape
    n = b.shape[0] if trans_b else b.shape[1]
    n_split, k_chunk = plan[2:]
    build()
    dev = a.device
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    ws = None
    if n_split > 1:
        ws = torch.empty(workspace_elems(m, n, n_split), dtype=torch.float32, device=dev)
    err = _lib.repro_gemm_update(
        0 if c is None else c.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), m, n, k,
        0 if c is None else c.stride(0), a.stride(0), b.stride(0), float(alpha),
        int(bool(trans_b)), _DTYPE_CODE[a.dtype], n_split, k_chunk,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gemm_update kernel launch failed: CUDA error {err}")
    gemm_update.launches += 1
    gemm_update.launches_split += n_split > 1
    return out


def gemm_update(
    c: Optional[torch.Tensor],
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
    tensor, a None C reading as zero: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. ``gemm_update.launches`` counts the calls
    that launched the kernel, ``gemm_update.launches_split`` those whose
    plan split k."""
    m, n, k = _check(c, a, b, trans_b, bm, bn, bk)
    dev = a.device
    if dev.type == "cpu":
        if c is None:
            c = torch.zeros((m, n), dtype=a.dtype)
        return gemm_update_plain(c, a, b, alpha=alpha, trans_b=trans_b)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    plan = gemm_plan(m, n, k)
    return _launch(c, a, b, alpha=alpha, trans_b=trans_b, plan=plan)


gemm_update.launches = 0
gemm_update.launches_split = 0


def matmul(
    a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128, bk: int = 128
) -> torch.Tensor:
    """Plain ``A @ B`` through the same kernel (C = 0, alpha = +1)."""
    return gemm_update(None, a, b, alpha=1.0, trans_b=False, bm=bm, bn=bn, bk=bk)
