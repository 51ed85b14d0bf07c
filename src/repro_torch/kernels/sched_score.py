"""Placement scoring of one activation: CUDA kernels + plain versions.

For every (ready task i, memory space u) pair, the transfer fold sums the
per-read transfer times of the reads that are not resident at u:

    X[i, u] = Σ_r  hops(mask[i, r], u) * per_read[i, r]

``hops`` is the paper-era PCIe path length: 0 if resident (or the data
exists nowhere yet), 1 to the host or when a host copy exists, 2 for
device→host→device. The fold over ``r`` runs in order from +0.0, so every
entry is bit-equal to ``repro``'s numpy rows; padded reads carry mask 0
and per-read time 0 and add an exact +0.0.

Counterpart of ``repro/kernels/sched_score.py`` and of the jitted
scoring function around it (``repro/core/backend.py:446``):

  * :func:`score_activation` — the main path: the wrapper of the
    hand-written CUDA kernel ``csrc/sched_score.cu`` that computes, in one
    launch, everything the reference's ``_build_matrix_fn`` computes for
    one activation (per-read times, the transfer fold, the ``col_of``
    gather, ``x_bias``, the row maxima, the affinity fold and ``C``). Its
    input is one flat buffer of 8-byte slots holding the ready tasks' CSR
    rows as they are (no padding), laid out by :func:`score_layout`;
    :func:`score_activation_plain` is its plain version over the same
    layout;
  * :func:`transfer_matrix_compact` — plain version of
    ``transfer_matrix_jnp`` (int32 compact codes: bit 0 host, bit u+1
    unique memory u);
  * :func:`transfer_matrix_from_full` — plain version of
    ``transfer_matrix_from_full`` (int64 full residency masks and the
    per-column shift ``mem+1``);
  * :func:`transfer_matrix` — the standalone counterpart of
    ``transfer_matrix_pallas`` (``repro/kernels/sched_score.py:121``): the
    transfer fold alone over dense padded reads, in the same CUDA source.
    It reads the full masks, so no compaction pass runs.

A wrapper given CPU tensors takes the plain version; given CUDA tensors it
launches its kernel or raises. f64 throughout: the H100 has native f64, so
the f32 relaxation the reference notes for TPUs does not apply. The
kernels are built with ``nvcc`` at first use into
``build/repro_torch_kernels/`` and loaded with ctypes (:mod:`._build`).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ._build import NVCC_FLAGS, build_library  # noqa: F401  (NVCC_FLAGS: this kernel's flags)

_SRC = Path(__file__).resolve().parent / "csrc" / "sched_score.cu"
SOURCES = (_SRC,)


def _hop_fold(
    masks: torch.Tensor,
    per_read: torch.Tensor,
    resident: torch.Tensor,
    host_col: torch.Tensor,
) -> torch.Tensor:
    """The in-order read fold shared by both plain versions.

    ``resident`` holds the (n, r, n_u) residency booleans of every read
    at every unique memory; the hop formula lives here once. Every term
    ``hops * per_read`` is formed at once, then added in read order.
    """
    skip = resident | (masks == 0)[:, :, None]
    hops = torch.where(
        host_col[None, None, :] | ((masks & 1) != 0)[:, :, None], 1.0, 2.0
    ).to(per_read.dtype).masked_fill(skip, 0.0)
    terms = hops * per_read[:, :, None]
    acc = torch.zeros(
        (masks.shape[0], host_col.shape[0]),
        dtype=per_read.dtype, device=per_read.device,
    )
    for r in range(masks.shape[1]):
        acc = acc + terms[:, r]
    return acc


def transfer_matrix_compact(
    masks: torch.Tensor,  # (n, r) int32 compact residency codes
    per_read: torch.Tensor,  # (n, r) f64 per-read transfer times
    col_bits: torch.Tensor,  # (n_u,) int32, bit u+1 set
    host_col: torch.Tensor,  # (n_u,) bool, True where unique mem u is the host
) -> torch.Tensor:
    """Plain fold over compact codes: (n × n_u) transfer times."""
    return _hop_fold(
        masks, per_read, (masks[:, :, None] & col_bits[None, None, :]) != 0, host_col
    )


def transfer_matrix_from_full(
    masks: torch.Tensor,  # (n, r) int64 full residency masks
    per_read: torch.Tensor,  # (n, r) f64 per-read transfer times
    mem_shift: torch.Tensor,  # (n_u,) int64, mem+1 per unique memory
    host_col: torch.Tensor,  # (n_u,) bool, True where unique mem u is the host
) -> torch.Tensor:
    """Plain fold straight off the full int64 residency masks."""
    return _hop_fold(masks, per_read, _resident(masks, mem_shift), host_col)


def _resident(masks: torch.Tensor, mem_shift: torch.Tensor) -> torch.Tensor:
    """(n, r, n_u) booleans: a valid copy of read r's datum at memory u."""
    return ((masks[:, :, None] >> mem_shift[None, None, :]) & 1) != 0


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
    fn = lib.repro_score_activation
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int64)]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
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


# ---------------------------------------------------------------------------
# one activation in one launch: the layout, its packing, the plain version
# and the kernel's wrapper

FLAG_X, FLAG_X_ROWS, FLAG_BIAS, FLAG_S, FLAG_ACCEL_ONLY, FLAG_C, FLAG_S_MISSING = (
    1, 2, 4, 8, 16, 32, 64)

# the sections of the three flat buffers, in order; every slot is 8 bytes
# (int64 or f64). The C struct ``Layout`` of csrc/sched_score.cu takes the
# offsets of all of them in this order.
IN_SECTIONS = ("r_indptr", "r_masks", "r_sizes", "w_indptr", "w_masks", "w_weights",
               "p_cpu", "p_gpu", "x_bias")
MACHINE_SECTIONS = ("latency", "bandwidth", "mem_shift", "host_col", "col_of", "accel_res")
OUT_SECTIONS = ("c", "x", "x_max", "s")
F64_SECTIONS = frozenset(
    ("r_sizes", "w_weights", "p_cpu", "p_gpu", "x_bias", "latency", "bandwidth")
)
MAX_UNIQUE_MEMS = 63  # bits 0..62 of a residency mask
MAX_SHIFT = 62


@dataclass(frozen=True)
class ScoreSpec:
    """What one activation holds and asks for.

    ``n`` ready tasks, ``nnz_r`` reads and ``nnz_w`` affinity accesses in
    all, ``n_u`` unique memories, ``n_res`` resources. ``want_x``: the
    transfer matrix X (full rows with ``x_rows``, else the row maxima;
    ``want_bias`` adds an (n × n_res) bias to it first). ``want_s``: the
    affinity matrix S (zero off accelerators with ``accel_only``); with
    ``s_missing`` the affinity accesses are the reads and their weights
    the read sizes, and S is the missing_bytes score: minus the hop fold
    of the sizes, ``-Σ hops(mask, u) · size`` (-0.0 where it is 0).
    ``want_c``: the cost ``C = base + X`` (``base`` without ``want_x``).
    """

    n: int
    nnz_r: int
    nnz_w: int
    n_u: int
    n_res: int
    want_x: bool = False
    x_rows: bool = False
    want_bias: bool = False
    want_s: bool = False
    accel_only: bool = False
    want_c: bool = False
    s_missing: bool = False

    def __post_init__(self) -> None:
        for name in ("n", "nnz_r", "nnz_w", "n_u", "n_res"):
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
                raise ValueError(f"{name} must be an int, got {v!r}")
            object.__setattr__(self, name, int(v))
        if self.n < 1 or self.n_res < 1:
            raise ValueError(f"an activation needs n >= 1 and n_res >= 1, got {self.n}, {self.n_res}")
        if not 1 <= self.n_u <= MAX_UNIQUE_MEMS:
            raise ValueError(f"n_u must be within [1, {MAX_UNIQUE_MEMS}], got {self.n_u}")
        if self.nnz_r < 0 or self.nnz_w < 0:
            raise ValueError(f"negative nnz: {self.nnz_r}, {self.nnz_w}")
        if self.nnz_r and not self.want_x:
            raise ValueError("reads given without want_x")
        if self.nnz_w and not self.want_s:
            raise ValueError("affinity accesses given without want_s")
        if (self.x_rows or self.want_bias) and not self.want_x:
            raise ValueError("x_rows and want_bias need want_x")
        if self.accel_only and not self.want_s:
            raise ValueError("accel_only needs want_s")
        if self.s_missing and (self.accel_only or not self.want_s):
            raise ValueError("s_missing needs want_s and excludes accel_only")
        if not (self.want_x or self.want_s or self.want_c):
            raise ValueError("the activation asks for no output")

    @property
    def flags(self) -> int:
        return (FLAG_X * self.want_x | FLAG_X_ROWS * self.x_rows | FLAG_BIAS * self.want_bias
                | FLAG_S * self.want_s | FLAG_ACCEL_ONLY * self.accel_only | FLAG_C * self.want_c
                | FLAG_S_MISSING * self.s_missing)


@functools.lru_cache(maxsize=4096)
def score_spec(**fields) -> ScoreSpec:
    """A :class:`ScoreSpec`, built and checked once per distinct activation
    shape."""
    return ScoreSpec(**fields)


@dataclass(frozen=True)
class ScoreLayout:
    """Slot offsets and lengths of each section of the input, machine and
    output buffers of one activation (built by :func:`score_layout`)."""

    spec: ScoreSpec
    inputs: Dict[str, Tuple[int, int]]
    machine: Dict[str, Tuple[int, int]]
    outputs: Dict[str, Tuple[int, int]]
    n_in: int
    n_mach: int
    n_out: int
    c_offsets: "ctypes.Array"  # the offsets in the order of the C struct


def _sections(names, lengths) -> Tuple[Dict[str, Tuple[int, int]], int]:
    out, off = {}, 0
    for name, k in zip(names, lengths):
        out[name] = (off, k)
        off += k
    return out, off


def machine_sections(n_u: int, n_res: int) -> Tuple[Dict[str, Tuple[int, int]], int]:
    """The machine buffer's sections (they depend on ``n_u`` and ``n_res``
    only) and its length in slots."""
    return _sections(MACHINE_SECTIONS, (1, 1, n_u, n_u, n_res, n_res))


@functools.lru_cache(maxsize=4096)
def score_layout(spec: ScoreSpec) -> ScoreLayout:
    """The one description of the three buffers of an activation."""
    n, nr = spec.n, spec.n * spec.n_res
    x, s, c = spec.want_x, spec.want_s, spec.want_c
    inputs, n_in = _sections(IN_SECTIONS, (
        (n + 1) * x, spec.nnz_r, spec.nnz_r, (n + 1) * s, spec.nnz_w, spec.nnz_w,
        n * c, n * c, nr * spec.want_bias,
    ))
    machine, n_mach = machine_sections(spec.n_u, spec.n_res)
    outputs, n_out = _sections(OUT_SECTIONS, (
        nr * c, nr * spec.x_rows, n * (x and not spec.x_rows), nr * s,
    ))
    offsets = [sec[name][0] for sec, names in ((inputs, IN_SECTIONS), (machine, MACHINE_SECTIONS),
                                               (outputs, OUT_SECTIONS)) for name in names]
    return ScoreLayout(spec, inputs, machine, outputs, n_in, n_mach, n_out,
                       (ctypes.c_int64 * len(offsets))(*offsets))


def _check_indptr(name: str, indptr: np.ndarray, n: int, nnz: int) -> None:
    if len(indptr) != n + 1 or indptr[0] != 0 or indptr[-1] != nnz or (np.diff(indptr) < 0).any():
        raise ValueError(f"{name} is no CSR row pointer of {n} rows over {nnz} entries")


def _write(buf: np.ndarray, sections, values: Dict[str, object], f64_names=F64_SECTIONS) -> None:
    """Write each named value into its section of ``buf`` (int64 slots;
    the sections named in ``f64_names`` as f64)."""
    f64 = buf.view(np.float64)
    for name, value in values.items():
        off, k = sections[name]
        dst = f64 if name in f64_names else buf
        if isinstance(value, (int, float, np.generic)):  # a scalar: one slot
            if k != 1:
                raise ValueError(f"section {name} holds {k} slots, got 1 value")
            dst[off] = value
            continue
        a = np.asarray(value).reshape(-1)
        if a.shape[0] != k:
            raise ValueError(f"section {name} holds {k} slots, got {a.shape[0]} values")
        dst[off:off + k] = a


def pack_activation(buf: np.ndarray, layout: ScoreLayout, *, reads=None, writes=None,
                    p_cpu=None, p_gpu=None, x_bias=None) -> None:
    """Write one activation into ``buf`` (int64, ``layout.n_in`` slots).

    ``reads``: (indptr, full masks, sizes) of the ready tasks' reads in
    CSR order; ``writes``: (indptr, full masks, weights) of their affinity
    accesses; ``p_cpu`` / ``p_gpu``: class durations; ``x_bias``: the
    (n × n_res) additive bias (the memory pressure, and on a machine that
    lost resources +inf over a detached column and the finite notice
    penalty over a noticed one: ``x + inf`` is +inf in X, its row maximum
    and C alike, and nothing else is infinite, so no NaN arises). Each is
    given exactly when the spec asks for it.
    """
    spec = layout.spec
    if buf.dtype != np.int64 or buf.shape != (layout.n_in,):
        raise ValueError(f"buf must be int64 of {layout.n_in} slots, got {buf.dtype} {buf.shape}")
    given = dict(reads=reads is not None, writes=writes is not None,
                 p=p_cpu is not None and p_gpu is not None, x_bias=x_bias is not None)
    want = dict(reads=spec.want_x, writes=spec.want_s, p=spec.want_c, x_bias=spec.want_bias)
    if given != want:
        raise ValueError(f"the spec asks for {want}, given {given}")
    values = {}
    if reads is not None:
        _check_indptr("r_indptr", reads[0], spec.n, spec.nnz_r)
        values.update(r_indptr=reads[0], r_masks=reads[1], r_sizes=reads[2])
    if writes is not None:
        _check_indptr("w_indptr", writes[0], spec.n, spec.nnz_w)
        values.update(w_indptr=writes[0], w_masks=writes[1], w_weights=writes[2])
    if p_cpu is not None:
        values.update(p_cpu=p_cpu, p_gpu=p_gpu)
    if x_bias is not None:
        values["x_bias"] = x_bias
    _write(buf, layout.inputs, values)


def pack_machine(n_res: int, *, latency: float, bandwidth: float, mem_shift, host_col,
                 col_of, accel_res) -> np.ndarray:
    """The machine buffer: per-machine constants every activation reads."""
    mem_shift = np.asarray(mem_shift, dtype=np.int64)
    col_of = np.asarray(col_of, dtype=np.int64)
    n_u = len(mem_shift)
    if not 1 <= n_u <= MAX_UNIQUE_MEMS or ((mem_shift < 0) | (mem_shift > MAX_SHIFT)).any():
        raise ValueError(f"mem_shift must hold 1..{MAX_UNIQUE_MEMS} shifts in [0, {MAX_SHIFT}]")
    if col_of.shape != (n_res,) or ((col_of < 0) | (col_of >= n_u)).any():
        raise ValueError(f"col_of must map {n_res} resources into [0, {n_u})")
    sections, n_mach = machine_sections(n_u, n_res)
    buf = np.zeros(n_mach, dtype=np.int64)
    _write(buf, sections, dict(
        latency=latency, bandwidth=bandwidth, mem_shift=mem_shift,
        host_col=np.asarray(host_col, dtype=np.int64), col_of=col_of,
        accel_res=np.asarray(accel_res, dtype=np.int64),
    ))
    return buf


def unpack(buf, sections, f64_names=F64_SECTIONS) -> Dict[str, object]:
    """Views of each section of a packed buffer (numpy array or tensor):
    int64 sections as they are, the f64 sections reinterpreted."""
    f64 = buf.view(torch.float64 if isinstance(buf, torch.Tensor) else np.float64)
    return {
        name: (f64 if name in f64_names else buf)[off:off + k]
        for name, (off, k) in sections.items()
    }


def unpack_outputs(out, layout: ScoreLayout) -> Dict[str, object]:
    """``C``, ``X`` (n × n_res), ``X_max`` (n) and ``S`` (n × n_res) views of
    an output buffer (f64 array or tensor); None for what was not asked."""
    spec = layout.spec
    got = unpack(out, layout.outputs)
    rows = (spec.n, spec.n_res)

    def view(name, shape):
        return got[name].reshape(shape) if len(got[name]) else None

    return dict(C=view("c", rows), X=view("x", rows), X_max=view("x_max", (spec.n,)),
                S=view("s", rows))


def _dense(indptr: torch.Tensor, values):
    """CSR rows gathered into dense (n × widest row) zero-padded blocks."""
    counts = indptr[1:] - indptr[:-1]
    pos = torch.arange(int(counts.max()), device=indptr.device)
    valid = pos[None, :] < counts[:, None]
    idx = torch.where(valid, indptr[:-1, None] + pos[None, :], 0)
    return [torch.where(valid, v[idx], 0) for v in values]


def score_activation_plain(packed_in: torch.Tensor, layout: ScoreLayout,
                           machine: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused kernel, over the same packed layout: the
    same IEEE operations in the reference's order (the division by a 0-d
    tensor, never by a Python scalar, so that no reciprocal replaces it).
    Returns the output buffer (f64, ``layout.n_out`` slots)."""
    spec = layout.spec
    n, n_res = spec.n, spec.n_res
    got = unpack(packed_in, layout.inputs)
    m = unpack(machine, layout.machine)
    mem_shift, col_of = m["mem_shift"], m["col_of"]
    host_col, accel = m["host_col"] != 0, m["accel_res"] != 0
    out = torch.empty(layout.n_out, dtype=torch.float64, device=packed_in.device)
    views = unpack_outputs(out, layout)
    X = None
    if spec.want_x:
        sizes = got["r_sizes"]
        per_read = torch.where(sizes <= 0.0, 0.0, m["latency"][0] + sizes / m["bandwidth"][0])
        masks, per_read = _dense(got["r_indptr"], [got["r_masks"], per_read])
        X = transfer_matrix_from_full(masks, per_read, mem_shift, host_col)[:, col_of]
        if spec.want_bias:
            X = X + got["x_bias"].reshape(n, n_res)
        if spec.x_rows:
            views["X"].copy_(X)
        else:
            views["X_max"].copy_(X.amax(dim=1))
    if spec.want_s:
        wm, ww = _dense(got["w_indptr"], [got["w_masks"], got["w_weights"]])
        if spec.s_missing:  # the reads' hop fold of their sizes, negated
            S_u = -_hop_fold(wm, ww, _resident(wm, mem_shift), host_col)
        else:
            terms = torch.where(_resident(wm, mem_shift), ww[:, :, None], 0.0)
            S_u = torch.zeros((n, spec.n_u), dtype=torch.float64, device=out.device)
            for r in range(ww.shape[1]):  # in access order from +0.0
                S_u = S_u + terms[:, r]
        S = S_u[:, col_of]
        if spec.accel_only:
            S = torch.where(accel[None, :], S, 0.0)
        views["S"].copy_(S)
    if spec.want_c:
        base = torch.where(accel[None, :], got["p_gpu"][:, None], got["p_cpu"][:, None])
        views["C"].copy_(base + X if X is not None else base)
    return out


def _check_activation(packed_in, layout, machine, out) -> None:
    if not isinstance(layout, ScoreLayout):
        raise ValueError(f"layout must be a ScoreLayout, got {type(layout).__name__}")
    for name, t, dtype, k in (("packed_in", packed_in, torch.int64, layout.n_in),
                              ("machine", machine, torch.int64, layout.n_mach),
                              ("out", out, torch.float64, layout.n_out)):
        if t is None:
            continue
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != k or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous 1-D {dtype} tensor of {k} slots, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    devices = {t.device for t in (packed_in, machine, out) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def score_activation(packed_in: torch.Tensor, layout: ScoreLayout, machine: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Score one activation: the fused CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. ``packed_in`` (int64, ``layout.n_in``
    slots) and ``machine`` (int64, ``layout.n_mach``) as
    :func:`pack_activation` and :func:`pack_machine` write them; returns
    the output buffer (f64, ``layout.n_out`` slots; written into ``out``
    when given). ``score_activation.launches`` counts the kernel
    launches."""
    _check_activation(packed_in, layout, machine, out)
    dev = packed_in.device
    if dev.type == "cpu":
        got = score_activation_plain(packed_in, layout, machine)
        return got if out is None else out.copy_(got)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if out is None:
        out = torch.empty(layout.n_out, dtype=torch.float64, device=dev)
    launch_score(packed_in.data_ptr(), machine.data_ptr(), out.data_ptr(), layout,
                 dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    return out


score_activation.launches = 0


def launch_score(in_ptr: int, machine_ptr: int, out_ptr: int, layout: ScoreLayout,
                 device_index: int, stream: int) -> None:
    """Launch the fused kernel on device pointers to buffers of the
    layout's sizes (:func:`score_activation` checks its tensors first; the
    scoring backend sizes its own) and count the launch."""
    build()
    spec = layout.spec
    err = _lib.repro_score_activation(
        in_ptr, machine_ptr, out_ptr, layout.c_offsets, spec.n, spec.n_u, spec.n_res,
        spec.flags, device_index, stream,
    )
    if err != 0:
        raise RuntimeError(f"score_activation kernel launch failed: CUDA error {err}")
    score_activation.launches += 1
