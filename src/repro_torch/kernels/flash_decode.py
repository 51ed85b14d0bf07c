"""One-token GQA decode attention over a KV cache: CUDA kernel + plain version.

The serving hot spot of the model stack: every attention layer of every
decode step reads the live part of the cache once.

Counterpart of ``repro/kernels/flash_decode.py`` and its oracle
``flash_decode_ref`` in ``repro/kernels/ref.py``:

  * :func:`flash_decode_plain` — ``flash_decode_ref`` in torch: K/V
    repeated over each group, logits and softmax in f32 with positions
    ``>= length`` masked to -1e30, the P.V product in f32, cast to q's
    dtype;
  * :func:`flash_decode` — the wrapper of the hand-written CUDA kernel
    ``csrc/flash_decode.cu`` that replaces the Pallas ``flash_decode``
    (``repro/kernels/flash_decode.py:65``). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.

Layout as the reference's: q ``(B, Hq, hd)``, the cache k and v
``(B, S, Hkv, hd)`` (seq-major), ``Hq % Hkv == 0``; returns ``(B, Hq, hd)``.
Any strides with unit stride along ``hd``. ``length`` is an int with
``1 <= length <= S``: the kernel reads only the live positions, and a
length of 0 would leave nothing to attend to. The Pallas kernel's block
size ``bk`` and ``interpret`` have no counterpart: the CUDA kernel has its
own tile and any ``S``. f32 or bf16, all three alike.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ._build import build_library

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232_448  # what one block may use on an H100 (dynamic shared memory)


def flash_decode_plain(q, k, v, length: int, *, scale: Optional[float] = None):
    """``flash_decode_ref`` in torch."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / hd**0.5
    kr = k.repeat_interleave(group, dim=2).float()  # (B, S, Hq, hd)
    vr = v.repeat_interleave(group, dim=2).float()
    logits = torch.einsum("bhd,bshd->bhs", q.float(), kr) * scale
    mask = torch.arange(S, device=q.device)[None, None, :] < length
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, vr).to(q.dtype)


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
    fn = lib.repro_flash_decode
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    _lib = lib
    return _build_log


def smem_bytes(group: int, hd: int) -> int:
    """Shared memory one block takes (``smem_bytes`` of ``csrc/flash_decode.cu``)."""
    tk = 32
    return 4 * (2 * group * hd + tk * (hd + 1) + tk * hd + group * tk + 3 * group)


def _check(q, k, v, length):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q (B, Hq, hd) and k, v (B, S, Hkv, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Hq, hd = q.shape
    Bk, S, Hkv, hdk = k.shape
    if Bk != B or hdk != hd or min(B, Hq, hd, S, Hkv) <= 0 or Hq % Hkv:
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, cache {tuple(k.shape)} "
            "(need one batch, one head dim and Hq % Hkv == 0)"
        )
    if not 1 <= length <= S:
        raise ValueError(f"length {length} outside 1..{S}")
    if smem_bytes(Hq // Hkv, hd) > MAX_SMEM_BYTES:
        raise ValueError(
            f"group {Hq // Hkv} x head dim {hd} needs {smem_bytes(Hq // Hkv, hd)} bytes of "
            f"shared memory, more than a block has ({MAX_SMEM_BYTES})"
        )
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k and v must all be float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if hd > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride along hd, got strides {t.stride()}")


def flash_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    length: int,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention of one token per sequence over the first ``length``
    cache positions: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. ``flash_decode.launches`` counts the kernel launches."""
    length = int(length)
    _check(q, k, v, length)
    dev = q.device
    if dev.type == "cpu":
        return flash_decode_plain(q, k, v, length, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, Hq, hd = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = 1.0 / hd**0.5
    build()
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=dev)
    qs, ks, vs, os_ = q.stride(), k.stride(), v.stride(), out.stride()
    strides = (ctypes.c_longlong * 10)(
        qs[0], qs[1], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], os_[0], os_[1]
    )
    err = _lib.repro_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hkv, Hq // Hkv, hd,
        length, ctypes.cast(strides, ctypes.c_void_p), float(scale), _DTYPE_CODE[q.dtype],
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
