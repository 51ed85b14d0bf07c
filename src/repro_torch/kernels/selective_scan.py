"""The selective scan of a Mamba block: one CUDA kernel and its plain versions.

Counterpart of the ``lax.scan`` of the per-token ``step`` in
``repro/models/mamba.py:82-98`` (through ``chunked_scan``,
``repro/models/recurrent.py:14``). The reference has no Pallas kernel here:
on the TPU the CUDA selective-scan kernel "becomes a ``jax.lax.scan``
recurrence" (``repro/models/mamba.py:3-6``). On the card a loop over the
sequence would be about six launches a token and a layer, so the card runs
one hand-written kernel instead (``csrc/selective_scan.cu``, whose note
gives its design and bound), in two instantiations:

  * :func:`mamba_scan` -- the fused Mamba scan, the path of
    ``models/mamba.py::mamba_apply``: from ``dt_r @ w_dt`` up to ``@ w_out``
    in one launch. For every batch row b and channel c, in the compute
    dtype E (f32 or bf16) with the recurrence in f32::

        dt    = softplus(dt_pre + dt_bias)         (the add and softplus in E)
        A     = -exp(a_log)                        (in E)
        h     <- state[b, c, :] or zeros
        for each t:
            h        = exp(dt A) h + (dt x) B[b, t, :]
            y        = sum_n h[n] C[b, t, n] + x d_skip
            g[b,t,c] = E(E(y) * silu(z))
        state[b, c, :] <- h                         (in place; only with a state)

    :func:`mamba_scan_plain` is exactly the composition ``mamba_apply`` ran
    before the fusion: softplus, ``A``, f32 copies, :func:`selective_scan_plain`,
    skip, cast, gate;
  * :func:`selective_scan` -- the plain f32 scan (``y``, ``hT``), the same
    kernel with the prologue and the epilogue off; off the path, kept with
    its contract and its tests. :func:`selective_scan_plain` is the
    reference's ``step`` looped in PyTorch
    (:func:`repro_torch.models.recurrent.chunked_scan`): the same products
    in the same order, the sum over n by ``.sum(-1)``.

Each wrapper checks its inputs and raises on what the kernel does not take,
on the CPU too; then a CPU tensor takes the plain version, and a CUDA
tensor launches the kernel or raises. ``mamba_scan.launches`` and
``selective_scan.launches`` count the calls that launched the kernel.
N is 16, the one state size of the repo's Mamba configs (the kernel is
built for it alone); S and din at least 1; batch at most 65 535.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.recurrent import chunked_scan
from ._build import build_library

_SRC = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
SOURCES = (_SRC,)
N_STATE = 16  # the kernel holds a channel's 16 states in one thread's registers
MAX_BATCH = 65_535  # the grid's second dimension
FUSED_DTYPES = (torch.float32, torch.bfloat16)
# repro_scan_plan's instantiations
PLAN_KINDS = {"selective_scan f32": 0, "mamba_scan f32": 1, "mamba_scan bf16": 2}


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


def mamba_scan_plain(dt_pre, xc, z, Bm, Cm, a_log, dt_bias, d_skip, state=None) -> torch.Tensor:
    """What ``mamba_apply`` computed between ``dt_r @ w_dt`` and ``@ w_out``
    before the fusion, op for op (``repro/models/mamba.py:79-100``): returns
    ``g``; ``state`` (the f32 ssm state) is read and then overwritten."""
    dt = F.softplus(dt_pre + dt_bias)  # (B, S, din)
    A = -torch.exp(a_log)  # (din, N), in the compute dtype
    xs_f32 = xc.float()
    h0 = (state if state is not None
          else torch.zeros((xc.shape[0], xc.shape[2], a_log.shape[1]), dtype=torch.float32,
                           device=xc.device))
    ys, hT = selective_scan_plain(
        dt.float().contiguous(), xs_f32.contiguous(), Bm.float().contiguous(),
        Cm.float().contiguous(), A.float().contiguous(), h0,
    )
    y = ys + xs_f32 * d_skip  # (B, S, din) f32
    g = y.to(xc.dtype) * F.silu(z)
    if state is not None:
        state.copy_(hT)
    return g


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
    fn = lib.repro_mamba_scan
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.repro_scan_plan
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    _lib, _build_log = lib, log
    return _build_log


def scan_plan(kind: str, device=None) -> Dict[str, int]:
    """The launch plan of one instantiation (a key of ``PLAN_KINDS``) on a
    CUDA device: threads and dynamic shared memory a block, the blocks an
    SM holds at once, steps a staged run."""
    build()
    dev = torch.device("cuda" if device is None else device)
    out = [ctypes.c_int() for _ in range(4)]
    err = _lib.repro_scan_plan(PLAN_KINDS[kind], dev.index or 0, *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"repro_scan_plan failed: CUDA error {err}")
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm", "run_steps"),
                    (v.value for v in out)))


def _same_device(named) -> torch.device:
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    return devices.pop()


def _check_sizes(batch, S, din, N) -> None:
    if min(batch, S, din) <= 0:
        raise ValueError(f"need batch, S and din of at least 1, got {(batch, S, din)}")
    if N != N_STATE:
        raise ValueError(f"state size N {N} is not {N_STATE}, the one the kernel takes")
    if batch > MAX_BATCH:
        raise ValueError(f"batch {batch} above {MAX_BATCH}")


def _check(dt, x, B, C, A, h0) -> None:
    """Raise on what the f32 scan does not take (the CPU path too)."""
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
    _check_sizes(batch, S, din, N)
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {t.stride()}")
    _same_device(named)


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


def _check_fused(dt_pre, xc, z, Bm, Cm, a_log, dt_bias, d_skip, state) -> torch.device:
    """Raise on what the fused scan does not take (the CPU path too);
    returns the inputs' device."""
    views = (("dt_pre", dt_pre), ("xc", xc), ("z", z), ("Bm", Bm), ("Cm", Cm))
    params = (("a_log", a_log), ("dt_bias", dt_bias), ("d_skip", d_skip))
    if xc.dim() != 3 or a_log.dim() != 2:
        raise ValueError(f"need xc (B, S, din) and a_log (din, N), got {tuple(xc.shape)}, "
                         f"{tuple(a_log.shape)}")
    batch, S, din = xc.shape
    N = a_log.shape[1]
    want = {"dt_pre": (batch, S, din), "xc": (batch, S, din), "z": (batch, S, din),
            "Bm": (batch, S, N), "Cm": (batch, S, N), "a_log": (din, N), "dt_bias": (din,),
            "d_skip": (din,), "state": (batch, din, N)}
    named = views + params + ((("state", state),) if state is not None else ())
    for name, t in named:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want[name]} (dt_pre, "
                             "xc, z (B, S, din); Bm, Cm (B, S, N); a_log (din, N); dt_bias, "
                             "d_skip (din,); state (B, din, N))")
    _check_sizes(batch, S, din, N)
    dtype = xc.dtype
    if dtype not in FUSED_DTYPES:
        raise ValueError(f"the compute dtype must be float32 or bfloat16, got {dtype}")
    for name, t in views + params:
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, want the compute dtype {dtype} (xc's)")
    if state is not None and state.dtype != torch.float32:
        raise ValueError(f"state must be float32, got {state.dtype}")
    for name, t in views:
        if t.stride(-1) != 1 and t.shape[-1] != 1:
            raise ValueError(f"{name} needs unit stride along its last axis, got strides "
                             f"{t.stride()}")
    for name, t in params + ((("state", state),) if state is not None else ()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {t.stride()}")
    return _same_device(named)


def mamba_scan(dt_pre, xc, z, Bm, Cm, a_log, dt_bias, d_skip, state=None) -> torch.Tensor:
    """``g`` of the fused Mamba scan: ``dt_pre`` (= ``dt_r @ w_dt``), ``xc``
    and ``z`` (B, S, din), ``Bm`` and ``Cm`` (B, S, N) -- views with unit
    stride along their last axis, as ``mamba_apply`` slices them --
    ``a_log`` (din, N), ``dt_bias`` and ``d_skip`` (din,), all in one
    compute dtype (f32 or bf16); ``state`` the (B, din, N) f32 ssm state,
    updated in place, or None (a prefill from zeros). The CUDA kernel on
    CUDA tensors, :func:`mamba_scan_plain` on CPU tensors.
    ``mamba_scan.launches`` counts the calls that launched the kernel."""
    dev = _check_fused(dt_pre, xc, z, Bm, Cm, a_log, dt_bias, d_skip, state)
    if dev.type == "cpu":
        return mamba_scan_plain(dt_pre, xc, z, Bm, Cm, a_log, dt_bias, d_skip, state)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    batch, S, din = xc.shape
    build()
    g = torch.empty((batch, S, din), dtype=xc.dtype, device=dev)
    strides = (ctypes.c_longlong * 10)(*(s for t in (dt_pre, xc, z, Bm, Cm)
                                         for s in t.stride()[:2]))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib.repro_mamba_scan(
        dt_pre.data_ptr(), xc.data_ptr(), z.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        a_log.data_ptr(), dt_bias.data_ptr(), d_skip.data_ptr(),
        None if state is None else state.data_ptr(), g.data_ptr(), strides, batch, S, din,
        a_log.shape[1], int(xc.dtype == torch.bfloat16), dev.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {err}")
    mamba_scan.launches += 1
    return g


mamba_scan.launches = 0
