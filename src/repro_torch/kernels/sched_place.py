"""Placement of one scheduling activation: CUDA kernels + plain versions.

After :func:`repro_torch.kernels.sched_score.score_activation` has scored
an activation, one of two kernels places it, reading the scorer's output
buffer where it lies:

  * :func:`dada_place` — DADA's λ search (paper Algorithm 2). Counterpart
    of the reference's jitted ``dada_lambda_search``
    (``repro/core/backend.py:522``, body ``_build_search_fn`` :633)
    together with the host ``try_build`` that rebuilds the placement at
    the λ it returns (``repro/core/dada.py:452-490``). From the cost
    matrix ``C``, the affinity matrix ``S`` (α > 0) and the row maxima of
    ``X`` (+CP) it computes each task's preferred resource, their
    ``(-score, tid)`` order, the upper bound, the bisection on λ and the
    placement at the settled λ: the rid of every task (ready order), the
    loads, λ and a status word. On a machine that has lost resources
    (``PlaceSpec.live``) it also takes their liveness: the detached
    resources are absent from the CPU and GPU lists and skipped by the
    preference scan, a noticed resource's column of ``C`` pays the
    remaining notice window, and the area bound and the search's upper
    bound count only what is alive (:func:`pack_dada`);
  * :func:`heft_select` — HEFT's earliest-finish-time scan. Counterpart
    of the jitted ``heft_select`` (``repro/core/backend.py:843``, body
    ``_build_heft_fn`` :877): tasks in priority order, each to the
    resource of least ``(start + X) + duration`` with the 1e-15
    strict-improvement rule; the chosen rid and finish time per task.

Both read their λ-independent host values from a placement section that
the caller appends to the scorer's packed input buffer
(:func:`place_layout` describes it, :func:`pack_dada` and
:func:`pack_heft` write it), so an activation on the card is one copy in,
two launches and one copy of the placement back. The kernels are in
``csrc/sched_place.cu``, built with ``nvcc`` at first use and loaded with
ctypes (:mod:`._build`).

A wrapper given CPU tensors takes the plain version (:func:`dada_place_plain`,
:func:`heft_select_plain`: the host loops of the reference, over Python
floats, in its op order); given CUDA tensors it launches its kernel or
raises. Results are bit-equal either way.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ._build import build_library
from .sched_score import ScoreLayout, ScoreSpec, _sections, _write, score_layout, unpack

_SRC = Path(__file__).resolve().parent / "csrc" / "sched_place.cu"
SOURCES = (_SRC,)

_TINY = 1e-12  # the slack of every DADA comparison (dada.py's _TINY)
_HEFT_TIE = 1e-15  # HEFT's strict-improvement margin

# the scorer's sections a placement reads: the class durations in its input
# buffer, the matrices in its output buffer
SCORE_IN_REFS = ("p_cpu", "p_gpu")
SCORE_OUT_REFS = ("c", "x", "x_max", "s")
# the placement section, appended to the scorer's input buffer, and the
# placement's own output buffer; every slot is 8 bytes (int64 or f64). The C
# struct ``Layout`` of csrc/sched_place.cu takes the offsets of the score
# references and of all these sections in this order.
PLACE_IN_SECTIONS = (
    # DADA
    "offsets", "flex_order", "tids", "max_off", "sum_max", "area", "off_total", "alpha",
    "two_alpha", "eps_rel", "max_iters", "cpu_rids", "gpu_rids",
    # DADA on a machine that lost resources (PlaceSpec.live)
    "pen", "skip", "n_alive", "pen_top",
    # HEFT
    "order", "durations", "cls_of_res", "load_ts", "now",
)
PLACE_OUT_SECTIONS = ("status", "iters", "lam", "loads", "rids", "efts")
PLACE_F64 = frozenset((
    "offsets", "max_off", "sum_max", "area", "off_total", "alpha", "two_alpha", "eps_rel",
    "pen", "n_alive", "pen_top", "durations", "load_ts", "now", "lam", "loads", "efts",
))
PLACE_WANT_S, PLACE_WANT_X, PLACE_AREA_BOUND, PLACE_LIVE = 1, 2, 4, 8
SMEM_LIMIT = 232448  # shared memory one block may use on an H100
DADA_MAX_RES = 256  # the DADA kernel's registers hold up to 8 rids a lane
# the DADA kernel's deepest midpoint tree (2^d - 1 warps) by rids a lane
# (1, 2, 4, 8): 31 warps leave 64 registers a thread, 15 leave 128
DADA_MAX_DEPTH = (5, 5, 5, 4)
HEFT_MAX_RES = 512  # the HEFT kernel's registers hold up to 16 time stamps a lane
HEFT_GROUP = 32  # tasks a buffer of the HEFT kernel's ring holds at most
HEFT_THREADS = 256
STATUS_OK, STATUS_INFEASIBLE = 0, 1


def _slot_class(n_res: int) -> int:
    """Rids a lane, rounded up to a power of two, as its exponent."""
    return max(0, ((n_res + 31) // 32 - 1).bit_length())


def dada_smem(n: int, n_res: int, depth: int, stage: int, live: bool = False) -> int:
    """The DADA kernel's shared memory (``dada_smem`` of csrc/sched_place.cu)
    at tree depth ``depth`` and staging level ``stage`` (0: nothing staged;
    1: the task vectors; 2: those and C): f64 words for the worst sum, the
    offsets, [the notice penalties, when ``live``], the preference scores,
    [p_cpu, p_gpu, x_max, tids, flex_order], [C]; int32 words for the
    chains, the preferred rids, the heads, each rid's position in the CPU /
    GPU list and two rounds of verdicts; one int16 rid a task for each of
    the 2^depth - 1 warps."""
    f64 = (1 + n_res + (n_res if live else 0) + n + (5 * n if stage >= 1 else 0)
           + (n * n_res if stage >= 2 else 0))
    i32 = 2 * n + 3 * n_res + 64
    return 8 * f64 + 4 * i32 + 2 * ((1 << depth) - 1) * n


def dada_plan(n: int, n_res: int, n_cpu: int, n_gpu: int,
              live: bool = False) -> Optional[Tuple[int, int, int]]:
    """(depth, stage, shared bytes) of the DADA kernel (``dada_plan`` of
    csrc/sched_place.cu): the deepest tree whose unstaged layout fits, then
    the most staging that fits beside it; None beyond the kernel."""
    if n < 1 or n_res < 1 or n_res > DADA_MAX_RES or n_cpu + n_gpu < 1:
        return None
    for depth in range(DADA_MAX_DEPTH[_slot_class(n_res)], 0, -1):
        if dada_smem(n, n_res, depth, 0, live) <= SMEM_LIMIT:
            stage = next(s for s in (2, 1, 0)
                         if dada_smem(n, n_res, depth, s, live) <= SMEM_LIMIT)
            return depth, stage, dada_smem(n, n_res, depth, stage, live)
    return None


def heft_plan(n: int, n_res: int, n_cls: int) -> Optional[Tuple[int, int, int]]:
    """(tasks a buffer, buffers, shared bytes) of the HEFT kernel
    (``heft_plan`` of csrc/sched_place.cu): one pass (X, the class
    durations and the order as they lie) where it fits, else a ring of two
    buffers of up to 32 tasks' X and duration rows; None beyond the
    kernel."""
    if n < 1 or n_res < 1 or n_res > HEFT_MAX_RES or n_cls < 1:
        return None
    one = 8 * (n * n_res + n_cls * n + n)
    if one <= SMEM_LIMIT:
        return n, 1, one
    group = min(HEFT_GROUP, SMEM_LIMIT // (32 * n_res))
    return (group, 2, 32 * group * n_res) if group >= 1 else None


@dataclass(frozen=True)
class PlaceSpec:
    """One activation's placement: ``kind`` "dada" or "heft", ``n`` ready
    tasks, ``n_res`` resources; DADA's ``n_cpu`` / ``n_gpu`` resource lists
    (the alive resources), ``area_bound`` and ``live`` (the section carries
    the liveness inputs: a resource is detached or noticed); HEFT's
    ``n_cls`` duration classes."""

    kind: str
    n: int
    n_res: int
    n_cpu: int = 0
    n_gpu: int = 0
    n_cls: int = 0
    area_bound: bool = False
    live: bool = False

    def __post_init__(self) -> None:
        if self.kind not in ("dada", "heft"):
            raise ValueError(f"kind must be 'dada' or 'heft', got {self.kind!r}")
        for name in ("n", "n_res", "n_cpu", "n_gpu", "n_cls"):
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, (int, np.integer)) or v < 0:
                raise ValueError(f"{name} must be an int >= 0, got {v!r}")
            object.__setattr__(self, name, int(v))
        if self.n < 1 or self.n_res < 1:
            raise ValueError(f"a placement needs n >= 1 and n_res >= 1, got {self.n}, {self.n_res}")
        if self.kind == "dada":
            if self.n_cpu + self.n_gpu < 1 or max(self.n_cpu, self.n_gpu) > self.n_res:
                raise ValueError(f"DADA needs 1..{self.n_res} CPU and GPU rids, got "
                                 f"{self.n_cpu} + {self.n_gpu}")
            if self.n_cls:
                raise ValueError("n_cls is HEFT's")
        else:
            if self.n_cls < 1:
                raise ValueError(f"HEFT needs n_cls >= 1, got {self.n_cls}")
            if self.n_cpu or self.n_gpu or self.area_bound or self.live:
                raise ValueError("n_cpu, n_gpu, area_bound and live are DADA's")

    @property
    def plan(self) -> Optional[Tuple[int, int, int]]:
        """The kernel's launch plan, as its launcher computes it: DADA's
        (tree depth, staging level, shared bytes) or HEFT's (tasks a
        buffer, buffers, shared bytes); None beyond the kernel."""
        if self.kind == "heft":
            return heft_plan(self.n, self.n_res, self.n_cls)
        return dada_plan(self.n, self.n_res, self.n_cpu, self.n_gpu, self.live)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of the kernel (csrc/sched_place.cu): the
        plan's, or beyond the kernel its least layout (DADA: one warp,
        nothing staged; HEFT: a ring of one task a buffer)."""
        plan = self.plan
        if plan is not None:
            return plan[2]
        if self.kind == "heft":
            return 32 * self.n_res
        return dada_smem(self.n, self.n_res, 1, 0, self.live)

    @property
    def fits_kernel(self) -> bool:
        """Whether the kernel takes it: a plan within the card's shared
        memory and, for DADA, at most 256 resources (8 a lane, the loads in
        registers); for HEFT, at most 512 (16 time stamps a lane)."""
        return self.plan is not None


@functools.lru_cache(maxsize=4096)
def place_spec(kind: str, n: int, n_res: int, n_cpu: int = 0, n_gpu: int = 0, n_cls: int = 0,
               area_bound: bool = False, live: bool = False) -> PlaceSpec:
    """A :class:`PlaceSpec`, built and checked once per distinct placement."""
    return PlaceSpec(kind, n, n_res, n_cpu, n_gpu, n_cls, area_bound, live)


@dataclass(frozen=True)
class PlaceLayout:
    """Slot offsets of the placement section (absolute in the input
    buffer, after the scorer's sections) and of the placement's output
    buffer; ``n_in`` is the whole input buffer's length."""

    spec: PlaceSpec
    score: ScoreLayout
    inputs: Dict[str, Tuple[int, int]]
    outputs: Dict[str, Tuple[int, int]]
    n_in: int
    n_out: int
    flags: int
    c_offsets: "ctypes.Array"  # the offsets in the order of the C struct


@functools.lru_cache(maxsize=4096)
def place_layout(spec: PlaceSpec, ss: ScoreSpec) -> PlaceLayout:
    """The one description of a placement's section and outputs, after the
    scorer's sections of the same activation (``ss``: what it scores)."""
    score = score_layout(ss)
    if (ss.n, ss.n_res) != (spec.n, spec.n_res):
        raise ValueError(f"the scorer's activation is {ss.n} x {ss.n_res}, the placement's "
                         f"{spec.n} x {spec.n_res}")
    n, n_res, dada = spec.n, spec.n_res, spec.kind == "dada"
    if dada and (not ss.want_c or ss.x_rows):
        raise ValueError("DADA places from C and the row maxima of X: want_c, and no x_rows")
    if not dada and not (ss.want_x and ss.x_rows):
        raise ValueError("HEFT places from the rows of X: want_x and x_rows")
    d, h, v = int(dada), int(not dada), int(spec.live)
    body, length = _sections(PLACE_IN_SECTIONS, (
        n_res * d, n * d, n * d, *(d,) * 8, spec.n_cpu, spec.n_gpu,
        n_res * v, n_res * v, v, v,
        n * h, spec.n_cls * n * h, n_res * h, n_res * h, h,
    ))
    inputs = {name: (score.n_in + off, k) for name, (off, k) in body.items()}
    outputs, n_out = _sections(PLACE_OUT_SECTIONS, (d, d, d, n_res * d, n, n * h))
    flags = (PLACE_WANT_S * ss.want_s | PLACE_WANT_X * ss.want_x
             | PLACE_AREA_BOUND * spec.area_bound | PLACE_LIVE * spec.live)
    offsets = ([score.inputs[name][0] for name in SCORE_IN_REFS]
               + [score.outputs[name][0] for name in SCORE_OUT_REFS]
               + [inputs[name][0] for name in PLACE_IN_SECTIONS]
               + [outputs[name][0] for name in PLACE_OUT_SECTIONS])
    return PlaceLayout(spec, score, inputs, outputs, score.n_in + length, n_out, flags,
                       (ctypes.c_int64 * len(offsets))(*offsets))


def _check_ids(name: str, ids, bound: int) -> None:
    if len(ids) and (min(ids) < 0 or max(ids) >= bound):
        raise ValueError(f"{name} must lie in [0, {bound})")


def pack_dada(buf: np.ndarray, layout: PlaceLayout, *, offsets, flex_order, tids, max_off,
              sum_max, area, off_total, alpha, eps_rel, max_iters, cpu_rids, gpu_rids,
              pen=None, skip=None, n_alive=None, pen_top=0.0) -> None:
    """Write DADA's placement section into ``buf`` (the whole int64 input
    buffer, ``layout.n_in`` slots; the scorer's sections are left as they
    are). ``offsets``: each resource's backlog beyond now; ``flex_order``:
    the flexible phase's task order; ``tids``: the tasks' ids (the
    preference order's tie-break); ``max_off``, ``sum_max`` (Σ max(p_cpu,
    p_gpu) in the host's order), ``area`` and ``off_total`` (read under
    ``area_bound``), α, ``eps_rel``, ``max_iters``; the CPU and GPU rids.

    A ``live`` layout also takes the liveness inputs: ``pen``, each
    column's notice penalty (0.0: none; C's noticed columns pay it),
    ``skip``, the columns the preference scan skips (detached, and noticed
    under recover), ``n_alive``, the resources the area bound counts, and
    ``pen_top``, n times the largest penalty, which the upper bound adds."""
    spec = layout.spec
    if spec.kind != "dada":
        raise ValueError("pack_dada needs a DADA layout")
    if spec.live != (pen is not None):
        raise ValueError("pen, skip, n_alive and pen_top go with a live layout, and only there")
    _check_ids("flex_order", flex_order, spec.n)
    _check_ids("cpu_rids", cpu_rids, spec.n_res)
    _check_ids("gpu_rids", gpu_rids, spec.n_res)
    values = dict(
        offsets=offsets, flex_order=flex_order, tids=tids, max_off=max_off, sum_max=sum_max,
        area=area, off_total=off_total, alpha=alpha, two_alpha=2.0 + alpha, eps_rel=eps_rel,
        max_iters=max_iters, cpu_rids=cpu_rids, gpu_rids=gpu_rids,
    )
    if spec.live:
        values.update(pen=pen, skip=skip, n_alive=float(n_alive), pen_top=pen_top)
    _write(buf, layout.inputs, values, PLACE_F64)


def pack_heft(buf: np.ndarray, layout: PlaceLayout, *, order, durations, cls_of_res, load_ts,
              now) -> None:
    """Write HEFT's placement section into ``buf``: the priority ``order``
    (task indices), the ``durations`` of each class (n_cls rows of n), each
    resource's class index, the load time stamps and ``now``."""
    spec = layout.spec
    if spec.kind != "heft":
        raise ValueError("pack_heft needs a HEFT layout")
    _check_ids("order", order, spec.n)
    _check_ids("cls_of_res", cls_of_res, spec.n_cls)
    _write(buf, layout.inputs, dict(order=order, durations=durations, cls_of_res=cls_of_res,
                                    load_ts=load_ts, now=now), PLACE_F64)


# ---------------------------------------------------------------------------
# the plain versions: the reference's host loops over Python floats


class DadaPlacement(NamedTuple):
    """The rid of every task (ready order), the final loads (by resource
    position), the settled λ, the status (``STATUS_INFEASIBLE``: λ = the
    upper bound did not fit; then rids are -1 and loads 0.0) and the
    number of bisection probes."""

    rids: List[int]
    loads: List[float]
    lam: float
    status: int
    iters: int


class HeftPlacement(NamedTuple):
    """The chosen rid and finish time of every task, in priority order."""

    rids: List[int]
    efts: List[float]


def preferences(S, C: Sequence[Sequence[float]], tids: Sequence[int], skip=None):
    """Each task's preferred resource and its order: ``(score, tid, rid,
    cost, task index)`` for every task whose affinity row has a score
    above the 1e-12 tolerance, sorted by ``(-score, tid)``. One pass per
    resource column reproduces the scalar rid-ascending scan from best =
    0, row by row; the lexsort equals ``sorted()`` because tids are
    unique. The columns where ``skip`` is true are passed over, as the
    scan passes over a detached (or, under recover, a noticed)
    resource."""
    S = np.asarray(S, dtype=np.float64)
    best = np.zeros(S.shape[0], dtype=np.float64)
    best_rid = np.full(S.shape[0], -1, dtype=np.int64)
    for rid in range(S.shape[1]):
        if skip is not None and skip[rid]:
            continue
        col = S[:, rid]
        upd = col > best + _TINY
        if upd.any():
            best[upd] = col[upd]
            best_rid[upd] = rid
    sel = np.nonzero(best_rid >= 0)[0]
    if not len(sel):
        return []
    ptids = np.asarray(tids, dtype=np.int64)[sel]
    order = np.lexsort((ptids, -best[sel])).tolist()
    sel, prids = sel.tolist(), best_rid[sel].tolist()
    scores, ptids = best[sel].tolist(), ptids.tolist()
    return [(scores[k], ptids[k], prids[k], C[sel[k]][prids[k]], sel[k]) for k in order]


def dada_place_plain(*, C, S, x_max, p_cpu, p_gpu, tids, flex_order, offsets, max_off, sum_max,
                     area, off_total, alpha, eps_rel, max_iters, area_bound, cpu_rids,
                     gpu_rids, pen=None, skip=None, n_alive=None, pen_top=0.0) -> DadaPlacement:
    """Plain version of the DADA kernel: DADA's λ search and placement over
    host values, in the reference's op order.

    ``C``: the (n × n_res) cost rows; ``S``: the affinity matrix (read
    when α > 0; None without); ``x_max``: the row maxima of X (+CP; None
    without); the rest as :func:`pack_dada` takes them, the liveness
    inputs included (None: every resource alive, none noticed): each
    noticed column of C pays its penalty, ``C + pen``, before anything
    reads C. ``dada_place_plain.calls`` counts the calls."""
    dada_place_plain.calls += 1
    n, n_res = len(tids), len(offsets)
    if pen is not None and any(p > 0.0 for p in pen):
        noticed = [(j, p) for j, p in enumerate(pen) if p > 0.0]
        C = [list(row) for row in C]
        for row in C:
            for j, p in noticed:
                row[j] += p
    if n_alive is None:
        n_alive = n_res
    two_alpha = 2.0 + alpha
    by_score = preferences(S, C, tids, skip) if alpha > 0.0 and S is not None else []
    have_both = bool(cpu_rids and gpu_rids)
    no_cpus, no_gpus = not cpu_rids, not gpu_rids
    any_rids = cpu_rids or gpu_rids
    all_idx = range(n)

    def try_build(lam: float) -> Optional[Tuple[List[int], List[float]]]:
        # loads only grow, so the first overflow of (2+α)λ already decides
        # the probe: same verdict as building fully
        cap = two_alpha * lam + _TINY
        if max_off > cap:
            return None
        if area_bound:
            capacity = lam * n_alive - off_total
            if area > capacity + _TINY:
                return None  # certificate: no λ-schedule exists
        loads = list(offsets)
        rid_of = [-1] * n

        # ---- local affinity phase (line 5-7) -----------------------------
        if by_score:
            budget = alpha * lam + _TINY
            for _, _, rid, c, i in by_score:
                if loads[rid] <= budget:
                    rid_of[i] = rid
                    v = loads[rid] + c
                    if v > cap:
                        return None
                    loads[rid] = v
            rem = [i for i in all_idx if rid_of[i] < 0]
        else:
            rem = all_idx

        # ---- global balance phase (line 8-9) -----------------------------
        for i in rem:  # reject if a task is larger than λ everywhere
            if (no_cpus or p_cpu[i] > lam) and (no_gpus or p_gpu[i] > lam):
                return None

        def eft(i, pool):  # earliest finish time; the first minimum wins
            crow = C[i]
            best_v = float("inf")
            best_rid = pool[0]
            for rid in pool:
                v = loads[rid] + crow[rid]
                if v < best_v:
                    best_v = v
                    best_rid = rid
            if best_v > cap:
                return False
            rid_of[i] = best_rid
            loads[best_rid] = best_v
            return True

        if not have_both:
            for i in rem:
                if not eft(i, any_rids):
                    return None
            return rid_of, loads
        flex = bytearray(n)
        for i in rem:
            if p_cpu[i] > lam:
                pool = gpu_rids  # dedicated to GPUs
            elif p_gpu[i] > lam:
                pool = cpu_rids  # dedicated to CPUs
            else:
                flex[i] = 1
                continue
            if not eft(i, pool):
                return None
        # flexible tasks: largest speedup first, to GPUs up to overreaching
        # λ, the rest to CPUs (earliest finish time)
        gpu_budget = lam + _TINY
        for i in flex_order:
            if not flex[i]:
                continue
            g = gpu_rids[0]
            gl = loads[g]
            for rid in gpu_rids[1:]:
                if loads[rid] < gl:
                    gl = loads[rid]
                    g = rid
            if gl <= gpu_budget:
                v = gl + C[i][g]
                if v > cap:
                    return None
                rid_of[i] = g
                loads[g] = v
            elif not eft(i, any_rids):
                return None
        # acceptance (line 10) already enforced incrementally above
        return rid_of, loads

    # binary search on λ (classical dual-approximation driver)
    worst_xfer = 0.0
    if x_max is not None:
        for v in x_max:
            worst_xfer += v
    upper = sum_max + max_off + worst_xfer + _TINY
    if pen_top:
        # the notice penalties inflate C: λ = upper stays feasible
        upper += pen_top
    lower = 0.0
    kept = None
    it = 0
    while upper - lower > eps_rel * upper and it < max_iters:
        lam = (upper + lower) / 2.0
        built = try_build(lam)
        if built is not None:
            upper = lam
            kept = built
        else:
            lower = lam
        it += 1
    if kept is None:
        kept = try_build(upper)
    if kept is None:
        return DadaPlacement([-1] * n, [0.0] * n_res, upper, STATUS_INFEASIBLE, it)
    return DadaPlacement(kept[0], kept[1], upper, STATUS_OK, it)


dada_place_plain.calls = 0


def heft_select_plain(*, X, order, durations, cls_of_res, load_ts, now) -> HeftPlacement:
    """Plain version of the HEFT kernel: the EFT scan over host values.

    ``X``: the (n × n_res) transfer rows; ``order``: the tasks in priority
    order; ``durations[cls_of_res[rid]][i]``: task i's duration on rid;
    ``load_ts`` (not modified) and ``now``. Each task goes to the rid of
    least ``(start + x) + d``, a later rid only when better by more than
    1e-15. ``heft_select_plain.calls`` counts the calls."""
    heft_select_plain.calls += 1
    lts = list(load_ts)
    cols = [durations[c] for c in cls_of_res]
    n_res = len(lts)
    inf = float("inf")
    rids, efts = [], []
    for i in order:
        xrow = X[i]
        best_eft = inf
        best_rid = 0
        for rid in range(n_res):
            lt = lts[rid]
            start = now if now > lt else lt
            eft = start + xrow[rid] + cols[rid][i]
            if eft < best_eft - _HEFT_TIE:
                best_eft = eft
                best_rid = rid
        lts[best_rid] = best_eft
        rids.append(best_rid)
        efts.append(best_eft)
    return HeftPlacement(rids, efts)


heft_select_plain.calls = 0


def _plain_inputs(packed_in: np.ndarray, scores: np.ndarray, layout: PlaceLayout) -> dict:
    """The plain version's keywords from the packed buffers (numpy), as
    Python values: only the sections the placement reads."""
    spec, score = layout.spec, layout.score
    n, n_res = spec.n, spec.n_res
    f64 = packed_in.view(np.float64)

    def get(arr, sections, name):
        a, k = sections[name]
        return arr[a:a + k]

    ins, outs = layout.inputs, score.outputs
    if spec.kind == "heft":
        return dict(X=get(scores, outs, "x").reshape(n, n_res).tolist(),
                    order=get(packed_in, ins, "order").tolist(),
                    durations=get(f64, ins, "durations").reshape(spec.n_cls, n).tolist(),
                    cls_of_res=get(packed_in, ins, "cls_of_res").tolist(),
                    load_ts=get(f64, ins, "load_ts").tolist(), now=float(get(f64, ins, "now")[0]))
    return dict(
        C=get(scores, outs, "c").reshape(n, n_res).tolist(),
        S=get(scores, outs, "s").reshape(n, n_res) if score.spec.want_s else None,
        x_max=get(scores, outs, "x_max").tolist() if score.spec.want_x else None,
        p_cpu=get(f64, score.inputs, "p_cpu").tolist(),
        p_gpu=get(f64, score.inputs, "p_gpu").tolist(),
        tids=get(packed_in, ins, "tids").tolist(),
        flex_order=get(packed_in, ins, "flex_order").tolist(),
        offsets=get(f64, ins, "offsets").tolist(),
        **{name: float(get(f64, ins, name)[0])
           for name in ("max_off", "sum_max", "area", "off_total", "alpha", "eps_rel")},
        max_iters=int(get(packed_in, ins, "max_iters")[0]), area_bound=spec.area_bound,
        cpu_rids=get(packed_in, ins, "cpu_rids").tolist(),
        gpu_rids=get(packed_in, ins, "gpu_rids").tolist(),
        **(dict(pen=get(f64, ins, "pen").tolist(), skip=get(packed_in, ins, "skip").tolist(),
                n_alive=float(get(f64, ins, "n_alive")[0]),
                pen_top=float(get(f64, ins, "pen_top")[0])) if spec.live else {}),
    )


def write_placement(out: np.ndarray, layout: PlaceLayout, placed) -> None:
    """Write a plain version's result into a placement output buffer (int64
    numpy array of ``layout.n_out`` slots), as the kernel writes it."""
    if layout.spec.kind == "heft":
        values = dict(rids=placed.rids, efts=placed.efts)
    else:
        values = dict(status=placed.status, iters=placed.iters, lam=placed.lam,
                      loads=placed.loads, rids=placed.rids)
    _write(out, layout.outputs, values, PLACE_F64)


def read_placement(out, layout: PlaceLayout):
    """A :class:`DadaPlacement` or :class:`HeftPlacement` from a placement
    output buffer (int64 numpy array)."""
    got = unpack(out, layout.outputs, PLACE_F64)
    if layout.spec.kind == "heft":
        return HeftPlacement(got["rids"].tolist(), got["efts"].tolist())
    return DadaPlacement(got["rids"].tolist(), got["loads"].tolist(), got["lam"].item(),
                         got["status"].item(), got["iters"].item())


# ---------------------------------------------------------------------------
# the CUDA kernels

_lib: Optional[ctypes.CDLL] = None
_build_log = ""


def build() -> str:
    """Build (or reuse) the kernel library from the repo's source and load
    it; returns the compiler's resource report (``-Xptxas -v``)."""
    global _lib, _build_log
    if _lib is not None:
        return _build_log
    lib, _build_log = build_library(_SRC)
    lib.repro_dada_place.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 6
        + [ctypes.c_void_p]
    )
    lib.repro_dada_place.restype = ctypes.c_int
    lib.repro_heft_select.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    )
    lib.repro_heft_select.restype = ctypes.c_int
    lib.repro_place_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int64)]
    lib.repro_place_plan.restype = ctypes.c_int
    _lib = lib
    return _build_log


def _check(kind, packed_in, scores, layout, out) -> torch.device:
    if not isinstance(layout, PlaceLayout) or layout.spec.kind != kind:
        raise ValueError(f"layout must be a {kind} PlaceLayout, got {layout!r}"[:200])
    for name, t, dtype, k in (("packed_in", packed_in, torch.int64, layout.n_in),
                              ("scores", scores, torch.float64, layout.score.n_out),
                              ("out", out, torch.int64, layout.n_out)):
        if t is None:
            continue
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != k or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous 1-D {dtype} tensor of {k} slots, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    devices = {t.device for t in (packed_in, scores, out) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    dev = packed_in.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not layout.spec.fits_kernel:
        raise ValueError(
            f"{kind} placement of {layout.spec.n} tasks x {layout.spec.n_res} resources is "
            f"beyond the kernel: {layout.spec.smem_bytes} bytes of shared memory (at most "
            f"{SMEM_LIMIT}), at most {DADA_MAX_RES} resources for DADA and {HEFT_MAX_RES} "
            f"for HEFT"
        )
    return dev


def dada_place(packed_in: torch.Tensor, scores: torch.Tensor, layout: PlaceLayout,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Place one activation by DADA: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. ``packed_in``: the whole input buffer
    (the scorer's sections and the placement section, int64,
    ``layout.n_in`` slots); ``scores``: the scorer's output buffer (f64).
    Returns the placement buffer (int64, ``layout.n_out`` slots; written
    into ``out`` when given; :func:`read_placement` reads it).
    ``dada_place.launches`` counts the kernel launches."""
    return _place("dada", packed_in, scores, layout, out)


dada_place.launches = 0


def heft_select(packed_in: torch.Tensor, scores: torch.Tensor, layout: PlaceLayout,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Place one activation by HEFT's EFT scan: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors; buffers as
    :func:`dada_place` takes them. ``heft_select.launches`` counts the
    kernel launches."""
    return _place("heft", packed_in, scores, layout, out)


heft_select.launches = 0


def _place(kind, packed_in, scores, layout, out) -> torch.Tensor:
    dev = _check(kind, packed_in, scores, layout, out)
    if out is None:
        out = torch.empty(layout.n_out, dtype=torch.int64, device=dev)
    if dev.type == "cpu":
        plain = dada_place_plain if kind == "dada" else heft_select_plain
        write_placement(out.numpy(), layout,
                        plain(**_plain_inputs(packed_in.numpy(), scores.numpy(), layout)))
    else:
        launch_placement(packed_in.data_ptr(), scores.data_ptr(), out.data_ptr(), layout,
                         dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    return out


def launch_placement(in_ptr: int, scores_ptr: int, out_ptr: int, layout: PlaceLayout,
                     device_index: int, stream: int) -> None:
    """Launch the layout's placement kernel on device pointers to buffers
    of its sizes (the wrappers check their tensors first; the scoring
    backend sizes its own) and count the launch on its wrapper."""
    build()
    spec = layout.spec
    if spec.kind == "dada":
        err = _lib.repro_dada_place(in_ptr, scores_ptr, out_ptr, layout.c_offsets, spec.n,
                                    spec.n_res, spec.n_cpu, spec.n_gpu, layout.flags,
                                    device_index, stream)
        counted = dada_place
    else:
        err = _lib.repro_heft_select(in_ptr, scores_ptr, out_ptr, layout.c_offsets, spec.n,
                                     spec.n_res, device_index, stream)
        counted = heft_select
    if err != 0:
        raise RuntimeError(f"{counted.__name__} kernel launch failed: CUDA error {err}")
    counted.launches += 1

