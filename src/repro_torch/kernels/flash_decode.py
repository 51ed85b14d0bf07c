"""One-token GQA decode attention over a KV cache: CUDA kernels + plain version.

The serving hot spot of the model stack: every attention layer of every
decode step reads the live part of the cache once.

Counterpart of ``repro/kernels/flash_decode.py`` and its oracle
``flash_decode_ref`` in ``repro/kernels/ref.py``:

  * :func:`flash_decode_plain` — ``flash_decode_ref`` in torch: K/V
    repeated over each group, logits and softmax in f32 with positions
    ``>= length`` masked to -1e30, the P.V product in f32, cast to q's
    dtype. Like the reference's oracle it takes a value head dim ``dv`` of
    its own (MLA's values are narrower than its queries and keys);
  * :func:`flash_decode` — the wrapper of two hand-written CUDA kernels
    that replace the Pallas ``flash_decode``
    (``repro/kernels/flash_decode.py:65``). A CPU tensor takes the plain
    version; a CUDA tensor launches a kernel or raises.

Routes, chosen by :func:`decode_route` before any launch (never by
catching a failure):

  * ``"split"`` — ``csrc/flash_decode_split.cu``, split-KV on the tensor
    cores: bf16; the query/key head dim ``dk`` and the value head dim
    ``dv`` multiples of 16 (``dv <= dk <= 256``); a group
    (``Hq / Hkv``) of at most 32; and every operand with unit stride
    along the head dim, a 16-byte-aligned base and its other strides
    multiples of 8 elements (16-byte rows for ``cp.async``). :func:`decode_splits`
    plans the grid; the f32 partial results go to scratch from
    ``torch.empty`` and a second kernel merges them;
  * ``"simt"`` — ``csrc/flash_decode.cu``, one block per (KV head,
    sequence) on the CUDA cores: everything else, f32 included (the f32
    contract forbids TF32, and f32 is not on the serving path).

``flash_decode.launches`` counts the calls that launched a kernel (one per
layer of a decode forward); ``flash_decode.launches_split`` those that took
the split route.

Layout as the reference's: q ``(B, Hq, dk)``, the cache k ``(B, S, Hkv,
dk)`` and v ``(B, S, Hkv, dv)`` (seq-major), ``Hq % Hkv == 0``, ``dv <= dk``;
returns ``(B, Hq, dv)``. The default ``scale`` is ``1 / sqrt(dk)``. Any
strides with unit stride along the head dim. ``length`` is an int with
``1 <= length <= S``: the kernels read only the live positions, and a
length of 0 would leave nothing to attend to. The Pallas kernel's block
size ``bk`` and ``interpret`` have no counterpart: the CUDA kernels have
their own tiles and any ``S``. f32 or bf16, all three alike.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from ._build import build_library

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"
_SRC_SPLIT = Path(__file__).resolve().parent / "csrc" / "flash_decode_split.cu"
SOURCES = (_SRC, _SRC_SPLIT)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232_448  # what one block may use on an H100 (dynamic shared memory)
TILE = 64  # cache positions per tile of the split kernel
N_SM = 132  # streaming multiprocessors of an H100 SXM
MAX_SPLIT_GROUP = 32  # query heads per KV head the split route takes (16-row slices)


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


def flash_decode_split_plain(q, k, v, length: int, *, scale: Optional[float] = None):
    """The split kernel's arithmetic in torch, f32 throughout: at
    :func:`decode_splits`' splits, each split's running max ``m``, sum ``l``
    and unnormalised ``acc``, then the log-sum-exp merge
    ``sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s`` with ``M = max_s m_s``."""
    B, Hq, hd = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / hd**0.5
    chunk, n_split = decode_splits(B, Hkv, length)
    kr = k[:, :length].repeat_interleave(group, dim=2).float()  # (B, length, Hq, hd)
    vr = v[:, :length].repeat_interleave(group, dim=2).float()
    ms, ls, accs = [], [], []
    for s0 in range(0, chunk * n_split, chunk):
        logits = torch.einsum("bhd,bshd->bhs", q.float(), kr[:, s0:s0 + chunk]) * scale
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhs,bshd->bhd", p, vr[:, s0:s0 + chunk]))
    m_all = torch.stack(ms)  # (n_split, B, Hq, 1)
    w = torch.exp(m_all - m_all.amax(dim=0))
    out = (w * torch.stack(accs)).sum(dim=0) / (w * torch.stack(ls)).sum(dim=0)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel

_lib: Optional[ctypes.CDLL] = None
_lib_split: Optional[ctypes.CDLL] = None
_build_log = ""


def build() -> str:
    """Build (or reuse) both kernel libraries from the repo's sources and
    load them; returns the compiler's resource reports (``-Xptxas -v``)."""
    global _lib, _lib_split, _build_log
    if _lib is not None and _lib_split is not None:
        return _build_log
    lib, log = build_library(_SRC)
    lib_split, log_split = build_library(_SRC_SPLIT)
    fn = lib.repro_flash_decode
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    fn = lib_split.repro_flash_decode_split
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p, ctypes.c_float,
                                                      ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    _lib, _lib_split = lib, lib_split
    _build_log = "\n".join(x for x in (log, log_split) if x)
    return _build_log


def decode_splits(batch: int, hkv: int, length: int, n_sm: int = N_SM) -> Tuple[int, int]:
    """``(chunk, n_split)`` of the split kernel's grid ``(n_split, Hkv, B)``.

    ``chunk`` is a power-of-two number of 64-position tiles, the largest
    that still gives about two blocks per SM where the length allows it;
    ``n_split = ceil(length / chunk)``, so every split holds at least one
    live position."""
    if min(batch, hkv, length, n_sm) <= 0:
        raise ValueError(f"need positive sizes, got {(batch, hkv, length, n_sm)}")
    tiles = -(-length // TILE)
    want = -(-2 * n_sm // (batch * hkv))  # splits for two blocks per SM
    per_split = max(1, tiles // want)
    chunk_tiles = 1 << (per_split.bit_length() - 1)  # a power of two <= per_split
    chunk = TILE * chunk_tiles
    return chunk, -(-length // chunk)


def split_smem_bytes(hd: int, dv: Optional[int] = None) -> int:
    """Shared memory of one split-kernel block (``split_smem_bytes`` of
    ``csrc/flash_decode_split.cu``): Q's 16 rows and a 3-stage ring of
    64-position K tiles (``hd`` wide) and V tiles (``dv``, default ``hd``),
    rows padded by 8 bf16."""
    dv = hd if dv is None else dv
    return 2 * ((hd + 8) * (16 + 3 * TILE) + (dv + 8) * 3 * TILE)


def _rows_16b(t: torch.Tensor) -> bool:
    """Unit stride along the last dim, a 16-byte-aligned base, and every
    other stride a multiple of 8 elements (16 bytes of bf16)."""
    return (
        t.stride(-1) == 1 and t.data_ptr() % 16 == 0
        and all(s % 8 == 0 for s in t.stride()[:-1])
    )


def decode_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"split"`` or ``"simt"`` for a call that passes :func:`_check`: a pure
    function of dtype, shape, strides and alignment (the module docstring
    states the rule)."""
    hd, dv = q.shape[-1], v.shape[-1]
    group = q.shape[1] // k.shape[2]
    if (
        all(t.dtype == torch.bfloat16 for t in (q, k, v)) and hd % 16 == 0 and hd <= 256
        and dv % 16 == 0 and group <= MAX_SPLIT_GROUP and all(_rows_16b(t) for t in (q, k, v))
    ):
        return "split"
    return "simt"


def smem_bytes(group: int, hd: int, dv: Optional[int] = None) -> int:
    """Shared memory one block takes (``smem_bytes`` of ``csrc/flash_decode.cu``;
    ``dv`` defaults to ``hd``)."""
    tk = 32
    dv = hd if dv is None else dv
    return 4 * (group * (hd + dv) + tk * (hd + 1) + tk * dv + group * tk + 3 * group)


def _check(q, k, v, length) -> str:
    """Raise on what neither kernel takes; return the call's route."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4 or k.shape[:-1] != v.shape[:-1]:
        raise ValueError(
            f"need q (B, Hq, dk), k (B, S, Hkv, dk) and v (B, S, Hkv, dv), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Hq, hd = q.shape
    Bk, S, Hkv, hdk = k.shape
    dv = v.shape[-1]
    if Bk != B or hdk != hd or min(B, Hq, hd, S, Hkv, dv) <= 0 or Hq % Hkv or dv > hd:
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, cache {tuple(k.shape)}, {tuple(v.shape)} "
            "(need one batch, one query/key head dim, a value head dim no wider and "
            "Hq % Hkv == 0)"
        )
    if not 1 <= length <= S:
        raise ValueError(f"length {length} outside 1..{S}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k and v must all be float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    route = decode_route(q, k, v)
    if route == "simt" and smem_bytes(Hq // Hkv, hd, dv) > MAX_SMEM_BYTES:
        raise ValueError(
            f"group {Hq // Hkv} x head dims {hd}/{dv} needs {smem_bytes(Hq // Hkv, hd, dv)} "
            f"bytes of shared memory, more than a block has ({MAX_SMEM_BYTES})"
        )
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride along hd, got strides {t.stride()}")
    return route


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
    CPU tensors, by the route of :func:`decode_route`.
    ``flash_decode.launches`` counts the calls that launched a kernel,
    ``flash_decode.launches_split`` those on the split route."""
    length = int(length)
    route = _check(q, k, v, length)
    dev = q.device
    if dev.type == "cpu":
        return flash_decode_plain(q, k, v, length, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, Hq, hd = q.shape
    Hkv, dv = k.shape[2], v.shape[-1]
    if scale is None:
        scale = 1.0 / hd**0.5
    build()
    out = torch.empty((B, Hq, dv), dtype=q.dtype, device=dev)
    qs, ks, vs, os_ = q.stride(), k.stride(), v.stride(), out.stride()
    strides = (ctypes.c_longlong * 10)(
        qs[0], qs[1], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], os_[0], os_[1]
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "split":
        chunk, n_split = decode_splits(B, Hkv, length)
        # f32 scratch: each split's m and l, then its acc, per (sequence, head)
        rows = B * Hq * n_split
        part = torch.empty((2 + dv) * rows, dtype=torch.float32, device=dev)
        p0 = part.data_ptr()
        err = _lib_split.repro_flash_decode_split(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), p0, p0 + 4 * rows,
            p0 + 8 * rows, B, Hkv, Hq // Hkv, hd, dv, length, chunk, n_split,
            ctypes.cast(strides, ctypes.c_void_p), float(scale), dev.index, stream,
        )
    else:
        err = _lib.repro_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hkv, Hq // Hkv, hd, dv,
            length, ctypes.cast(strides, ctypes.c_void_p), float(scale), _DTYPE_CODE[q.dtype],
            dev.index, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_decode {route} kernel launch failed: CUDA error {err}")
    flash_decode.launches += 1
    flash_decode.launches_split += route == "split"
    return out


flash_decode.launches = 0
flash_decode.launches_split = 0
