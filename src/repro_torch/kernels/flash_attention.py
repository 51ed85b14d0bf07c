"""GQA prefill attention with an online softmax: CUDA kernels + plain version.

The prefill hot spot of the model stack: every attention layer of a
prompt's forward pass.

Counterpart of ``repro/kernels/flash_attention.py`` and its oracle
``flash_attention_ref`` in ``repro/kernels/ref.py``:

  * :func:`flash_attention_plain` — ``flash_attention_ref`` in torch: K/V
    repeated over each group, logits and softmax in f32, the bottom-right
    causal mask (``tril(k = sk - sq)``), the result cast to q's dtype. Like
    the reference's oracle it takes a value head dim ``dv`` of its own
    (MLA's values are narrower than its queries and keys);
  * :func:`flash_attention` — the wrapper of two hand-written CUDA kernels
    that replace the Pallas ``flash_attention``
    (``repro/kernels/flash_attention.py:71``). A CPU tensor takes the plain
    version; a CUDA tensor launches a kernel or raises.

Routes, chosen by :func:`attention_route` before any launch (never by
catching a failure):

  * ``"tc"`` — ``csrc/flash_attention_sm90.cu``, bf16 on the tensor cores
    (wgmma fed by TMA): q, k and v all bf16; the query/key head dim ``dk``
    a multiple of 16 from 48 to 128 and the value head dim ``dv`` a
    multiple of 16 (at most ``dk``), so that more than half of each
    64-wide TMA box of q and k is data (TMA zero-fills the rest: exact);
    every operand's base 16-byte aligned and its batch, head and seq
    strides multiples of 8 elements (a batch of one excepted), as TMA
    needs;
  * ``"simt"`` — ``csrc/flash_attention.cu`` on the CUDA cores in f32:
    everything else, f32 (no TF32), ``dk`` 32 or 256 and unaligned views
    included.

``flash_attention.launches`` counts every call that launched a kernel (one
per layer of a prefill forward); ``flash_attention.launches_tc`` those that
took the tensor-core route.

Layout as the reference's: q ``(hq, sq, dk)``, k ``(hk, sk, dk)`` and v
``(hk, sk, dv)`` with ``hq % hk == 0`` and ``dv <= dk``, returning
``(hq, sq, dv)``. A leading batch dimension is also taken
(``(B, hq, sq, dk)`` and ``(B, hk, sk, ·)``), with any strides so long as
the head dim has unit stride: the model's ``(B, S, H, d)`` projections go
in as ``transpose(1, 2)`` views, one launch per layer. The default
``scale`` is ``1 / sqrt(dk)``. The Pallas kernel's block sizes (``bq``,
``bk``) and ``interpret`` have no counterpart: the CUDA kernels have their
own tiles and mask ragged ``sq`` and ``sk`` themselves. f32 or bf16, all
three alike; ``dk <= 256``. A causal call with ``sq > sk`` raises: its
first rows would see no key, where the reference's oracle gives NaN.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ._build import build_library

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_SRC_TC = Path(__file__).resolve().parent / "csrc" / "flash_attention_sm90.cu"
SOURCES = (_SRC, _SRC_TC)
TC_HEAD_DIMS = range(48, 129, 16)  # dk of the tensor-core route (dv: a multiple of 16 <= dk)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_plain(q, k, v, *, causal: bool = True, scale: Optional[float] = None):
    """``flash_attention_ref`` in torch; also takes a leading batch dim."""
    hq, sq, d = q.shape[-3:]
    hk, sk = k.shape[-3], k.shape[-2]
    group = hq // hk
    if scale is None:
        scale = 1.0 / d**0.5  # of the query/key head dim
    k = k.repeat_interleave(group, dim=-3)
    v = v.repeat_interleave(group, dim=-3)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return (p @ v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel

_lib: Optional[ctypes.CDLL] = None
_lib_tc: Optional[ctypes.CDLL] = None
_build_log = ""


def build() -> str:
    """Build (or reuse) both kernel libraries from the repo's sources and
    load them; returns the compiler's resource reports (``-Xptxas -v``)."""
    global _lib, _lib_tc, _build_log
    if _lib is not None and _lib_tc is not None:
        return _build_log
    lib, log = build_library(_SRC)
    lib_tc, log_tc = build_library(_SRC_TC)
    args = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_float]
        + [ctypes.c_int] * 2
    )
    lib.repro_flash_attention.argtypes = args + [ctypes.c_int, ctypes.c_void_p]
    lib.repro_flash_attention.restype = ctypes.c_int
    lib_tc.repro_flash_attention_sm90.argtypes = args + [ctypes.c_void_p]
    lib_tc.repro_flash_attention_sm90.restype = ctypes.c_int
    _lib, _lib_tc = lib, lib_tc
    _build_log = "\n".join(x for x in (log, log_tc) if x)
    return _build_log


def attention_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"tc"`` or ``"simt"`` for a call that passes :func:`_check`: a pure
    function of dtype, shape, strides and alignment (the module docstring
    states the rule)."""
    if (not all(t.dtype == torch.bfloat16 for t in (q, k, v)) or q.shape[-1] not in TC_HEAD_DIMS
            or v.shape[-1] % 16):
        return "simt"
    batch = q.shape[0] if q.dim() == 4 else 1
    for t in (q, k, v):
        strides = _bhs_strides(t)[1:] if batch == 1 else _bhs_strides(t)  # one: no batch stride
        if t.data_ptr() % 16 or t.stride(-1) != 1 or any(s % 8 for s in strides):
            return "simt"
    return "tc"


def _check(q, k, v, causal):
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError(
            f"q, k, v must all be (h, s, d) or all (B, h, s, d), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape[:-1] != v.shape[:-1]:
        raise ValueError(f"k and v differ in shape: {tuple(k.shape)} vs {tuple(v.shape)}")
    hq, sq, d = q.shape[-3:]
    hk, sk, dk = k.shape[-3:]
    dv = v.shape[-1]
    if q.dim() == 4 and k.shape[0] != q.shape[0]:
        raise ValueError(f"batch sizes differ: q {q.shape[0]}, k {k.shape[0]}")
    if dk != d or min(hq, hk, sq, sk, d, dv) <= 0 or hq % hk or dv > d:
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "(need hq % hk == 0, one query/key head dim and a value head dim no wider)"
        )
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if causal and sq > sk:
        raise ValueError(f"causal attention with sq {sq} > sk {sk}: rows with no key")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k and v must all be float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if d > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride along d, got strides {t.stride()}")


def _bhs_strides(t):
    """(batch, head, seq) strides of a 3-D or 4-D operand."""
    s = t.stride()
    return (0, *s[:2]) if t.dim() == 3 else s[:3]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of ``q`` over ``k``/``v`` (GQA; bottom-right causal mask
    when ``causal``): the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors, by the route of :func:`attention_route`.
    ``flash_attention.launches`` counts the calls that launched a kernel,
    ``flash_attention.launches_tc`` those on the tensor-core route.

    On the card, a 4-D call returns a ``(B, hq, sq, dv)`` view of a
    ``(B, sq, hq, dv)`` tensor, so that ``out.transpose(1, 2)`` is
    contiguous."""
    _check(q, k, v, causal)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    hq, sq, d = q.shape[-3:]
    hk, sk = k.shape[-3], k.shape[-2]
    dv = v.shape[-1]
    if scale is None:
        scale = 1.0 / d**0.5
    build()
    route = attention_route(q, k, v)
    if q.dim() == 4:
        out = torch.empty((q.shape[0], sq, hq, dv), dtype=q.dtype, device=dev).transpose(1, 2)
    else:
        out = torch.empty((hq, sq, dv), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *_bhs_strides(q), *_bhs_strides(k), *_bhs_strides(v), *_bhs_strides(out)
    )
    batch = q.shape[0] if q.dim() == 4 else 1
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), batch, hq, hk, sq, sk, d, dv,
        ctypes.cast(strides, ctypes.c_void_p), float(scale), int(bool(causal)),
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "tc":
        err = _lib_tc.repro_flash_attention_sm90(*args, dev.index, stream)
    else:
        err = _lib.repro_flash_attention(*args, _DTYPE_CODE[q.dtype], dev.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: error {err}")
    flash_attention.launches += 1
    flash_attention.launches_tc += route == "tc"
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
