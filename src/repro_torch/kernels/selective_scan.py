"""The selective scan of a Mamba block: a CUDA kernel and its plain version.

Counterpart of the ``lax.scan`` of the per-token ``step`` in
``repro/models/mamba.py:82-98`` (through ``chunked_scan``,
``repro/models/recurrent.py:14``). The reference has no Pallas kernel here:
on the TPU the CUDA selective-scan kernel "becomes a ``jax.lax.scan``
recurrence" (``repro/models/mamba.py:3-6``). On the card a loop over the
sequence would be about six launches a token and a layer, so the card runs
one hand-written kernel instead (``csrc/selective_scan.cu``, whose note
gives its design and bound). For every batch row b and channel c, in f32::

    h <- h0[b, c, :]
    for each t:
        a_bar    = exp(dt[b, t, c] * A[c, :])
        h        = a_bar * h + (dt[b, t, c] * x[b, t, c]) * B[b, t, :]
        y[b,t,c] = sum_n h[n] * C[b, t, n]
    hT[b, c, :] <- h

  * :func:`selective_scan_plain` -- the reference's ``step`` looped in
    PyTorch (:func:`repro_torch.models.recurrent.chunked_scan`): the same
    products in the same order, the sum over n by ``.sum(-1)``. The CPU
    tests use it, and ``chip_smoke.py`` holds the kernel against it;
  * :func:`selective_scan` -- the wrapper: a CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.

Shapes: ``dt``, ``x`` (B, S, din); ``B``, ``C`` (B, S, N); ``A`` (din, N);
``h0`` (B, din, N); returns ``y`` (B, S, din) and ``hT`` (B, din, N). Every
input f32 and contiguous, on one device; N 16, the one state size of the
repo's Mamba configs (the kernel is built for it alone); S and din at least
1.
``selective_scan.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..models.recurrent import chunked_scan
from ._build import build_library

_SRC = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
SOURCES = (_SRC,)
N_STATE = 16  # the kernel's four lanes a channel hold four states each
MAX_BATCH = 65_535  # the grid's second dimension


def selective_scan_plain(dt, x, B, C, A, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``step`` (``repro/models/mamba.py:82-88``) looped
    over the sequence."""

    def step(h, inp):
        dt_t, b_t, c_t, x_t = inp  # (B, din) (B, N) (B, N) (B, din)
        a_bar = torch.exp(dt_t[..., None] * A[None])  # (B, din, N)
        bx = (dt_t * x_t)[..., None] * b_t[:, None, :]  # (B, din, N)
        h = a_bar * h + bx
        return h, (h * c_t[:, None, :]).sum(-1)  # (B, din)

    seq = (dt.transpose(0, 1), B.transpose(0, 1), C.transpose(0, 1), x.transpose(0, 1))
    hT, ys = chunked_scan(step, h0, seq)
    return ys.transpose(0, 1).contiguous(), hT


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
    lib, log = build_library(_SRC)
    fn = lib.repro_selective_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib, _build_log = lib, log
    return _build_log


def _check(dt, x, B, C, A, h0) -> None:
    """Raise on what the kernel does not take (the CPU path too)."""
    named = (("dt", dt), ("x", x), ("B", B), ("C", C), ("A", A), ("h0", h0))
    if dt.dim() != 3 or A.dim() != 2:
        raise ValueError(f"need dt (B, S, din) and A (din, N), got {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}")
    batch, S, din = dt.shape
    N = A.shape[1]
    want = {"dt": (batch, S, din), "x": (batch, S, din), "B": (batch, S, N),
            "C": (batch, S, N), "A": (din, N), "h0": (batch, din, N)}
    for name, t in named:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want[name]} "
                             "(dt, x (B, S, din); B, C (B, S, N); A (din, N); h0 (B, din, N))")
    if min(batch, S, din) <= 0:
        raise ValueError(f"need batch, S and din of at least 1, got {(batch, S, din)}")
    if N != N_STATE:
        raise ValueError(f"state size N {N} is not {N_STATE}, the one the kernel takes")
    if batch > MAX_BATCH:
        raise ValueError(f"batch {batch} above {MAX_BATCH}")
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {t.stride()}")
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def selective_scan(dt, x, B, C, A, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, hT)`` of the selective scan: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors. ``selective_scan.launches`` counts
    the calls that launched the kernel."""
    _check(dt, x, B, C, A, h0)
    dev = dt.device
    if dev.type == "cpu":
        return selective_scan_plain(dt, x, B, C, A, h0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    batch, S, din = dt.shape
    build()
    y = torch.empty_like(dt)
    hT = torch.empty_like(h0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib.repro_selective_scan(
        dt.data_ptr(), x.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(), h0.data_ptr(),
        y.data_ptr(), hT.data_ptr(), batch, S, din, A.shape[1], dev.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    selective_scan.launches += 1
    return y, hT


selective_scan.launches = 0
