"""The surrogate episode scan: a CUDA kernel and its plain version.

Counterpart of the jitted ``episode`` body of
``repro/core/episode.py::_build_episode_fn`` (:363, body :404-635) — a
``lax.scan`` over task steps, ``vmap``-ed over configurations — together
with the Pallas transfer fold it calls at every step
(``repro/kernels/sched_score.py:121`` ``transfer_matrix_pallas``, through
``xfer_rows`` at ``episode.py:376-382``, with the configurations as the
kernel's row axis).

  * :func:`episode_scan` — the wrapper: CPU tensors take the plain
    version, CUDA tensors launch the hand-written kernel
    ``csrc/sched_episode.cu`` (one warp per configuration, several
    configurations a block, every step on the warp, the transfer fold
    folded into the step) or raise. ``episode_scan.launches`` counts the
    launches: one per call, which ``run_episodes`` makes once per (graph,
    machine template) group. The configurations' scan state lives in a
    global scratch buffer.
  * :func:`episode_plain` — the plain version: a Python loop over steps
    with the batch axis written out, op for op as the reference, the
    ready set's maximum taken at every step. Its transfer rows come from
    :func:`.sched_score.transfer_matrix_compact` with the configurations
    as rows.
  * :func:`selection_order` — the tasks in the order the scan selects
    them. Selection depends only on the plan's priorities and indegrees,
    never on a configuration, so the kernel reads this order (computed
    once per plan by ``core/episode.py::build_plan``) instead of scanning
    a ready set.
  * :class:`PlanTables` — what the kernel reads in place of the plan's
    own rows: the order and the packed task records, on the inputs'
    device, bound to the very tensors they were derived from
    (:func:`plan_tables` from any inputs; ``core/episode.py::episode_tables``
    once per plan and device). The wrapper refuses tables whose sources
    are not the inputs it is given, or were changed in place since.

Arithmetic. The reference runs the scan in f32 and XLA on the CPU
compiles it with multiply-add contraction, so the port contracts exactly
where the reference's compiled scan does and rounds every other op on
its own: the score's ``base + use_cp·X`` and ``… − α·aff`` and the
finish time ``(start + xfer_t) + dur·noise`` are single-rounded fused
multiply-adds (:func:`fma_f32` here, ``__fmaf_rn`` in the kernel); every
other product is by 0, 1 or 2 and exact. Sums over reads and writes run
in index order from +0.0. Argmax / argmin keep the first index among
equals. So the plain version, the kernel and the reference agree bit
for bit.

Scatters drop out-of-range ids (pads carry distinct dummy ids past the
state's edge, inactive steps shift theirs out of range), gathers clamp,
``indeg`` and ``ready_t`` carry one extra slot that the first successor
pad hits, and the dummy data slot is reset to host / -1 every step (the
plain version; the kernel never writes the dummy slot, and keeps no
extra slot, which nothing reads).
"""
from __future__ import annotations

import ctypes
import heapq
from pathlib import Path
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ._build import build_library
from .sched_score import transfer_matrix_compact

_SRC = Path(__file__).resolve().parent / "csrc" / "sched_episode.cu"
SOURCES = (_SRC,)

_NEVER = 1 << 30  # indegree / touch sentinel: never ready, never a victim
_K_EVICT = 8  # LRU eviction rounds per placement (capacity-bounded batches)
# the kernel's launch plan (episode_plan of csrc/sched_episode.cu)
WARPS = 2  # configurations a block, one warp each (fewer where they do not fit)
MAX_RES = 32  # resources a configuration at most, one lane each
SMEM_LIMIT = 232448  # shared memory one block may use on an H100
SCHEDULE_COLUMNS = ("tid", "rid", "act", "start", "xfer_t", "fin", "xfer_b", "evict_b")
_ARG_NAMES = (
    "read_ids", "read_t", "read_sz", "write_ids", "write_sz", "succ_ids",
    "indeg0", "prio", "dur_cpu", "dur_gpu", "sizes", "col_bits", "host_col",
    "is_gpu", "valid_res", "mem_col", "link_grp", "alpha", "use_cp", "ws_pref",
    "noise", "cap", "bandwidth",
)
_INT_ARGS = frozenset(("read_ids", "write_ids", "succ_ids", "indeg0", "col_bits",
                       "mem_col", "link_grp"))
_BOOL_ARGS = frozenset(("host_col", "is_gpu", "valid_res", "ws_pref"))
_N_SOURCES = 10  # read_ids .. dur_gpu: the inputs the tables are derived from


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as a fused multiply-add gives it.

    The f32 product is exact in f64 and the sum is rounded to odd there
    (the nearest f64, moved one ulp toward the exact value when it is
    inexact and even), so the final rounding to f32 is the single
    rounding of the exact value (53 ≥ 24 + 2 bits).
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)  # the exact s - (p + c), TwoSum
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where(fix, torch.nextafter(s, toward), s)
    return s.float()


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Row-wise index of the least value, the first among equals."""
    iota = torch.arange(x.shape[1], device=x.device)
    m = x.min(dim=1, keepdim=True).values
    return torch.where(x == m, iota, x.shape[1] - 1).min(dim=1).values


def _put(state, rows, idx, val, op="set"):
    """Scatter ``val`` into ``state[rows, idx]``, dropping ids out of range
    (ids are unique within a row)."""
    ok = idx < state.shape[1]
    r, i = rows.expand_as(idx)[ok], idx[ok]
    v = val.expand_as(idx)[ok]
    if op == "add":
        v = state[r, i] + v
    elif op == "max":
        v = torch.maximum(state[r, i], v)
    state[r, i] = v


def _row_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 in index order from +0.0."""
    acc = torch.zeros_like(terms[:, 0])
    for j in range(terms.shape[1]):
        acc = acc + terms[:, j]
    return acc


def selection_order(indeg0: np.ndarray, prio: np.ndarray, succ_ids: np.ndarray) -> np.ndarray:
    """The tasks in the order the scan selects them (int32).

    The scan takes the ready set's greatest ``prio``, the least index
    among equals, retires it and lowers its successors' indegrees; a task
    joins the ready set when its indegree reaches exactly 0. None of that
    depends on a configuration, so one order serves the whole batch. A
    heap keyed by (−prio, index) gives it; ``prio`` is the f32 vector the
    scan compares (two f64 ranks that round to one f32 value tie, and the
    lesser index wins). A task of priority −inf is never taken: the order
    ends where the scan's ready set holds only such tasks, and every later
    step is inactive. Successor ids ≥ ``len(prio)`` are pads.
    """
    prio = np.asarray(prio)
    if prio.dtype != np.float32:
        raise ValueError(f"the scan compares f32 priorities, got {prio.dtype}")
    if np.isnan(prio).any():
        raise ValueError("a priority is NaN")
    n_pad = prio.shape[0]
    key = (-prio.astype(np.float64)).tolist()
    indeg = np.asarray(indeg0)[:n_pad].tolist()
    real = np.asarray(succ_ids) < n_pad
    flat = np.asarray(succ_ids)[real].tolist()
    ends = np.cumsum(real.sum(axis=1)).tolist()
    heap = [(key[i], i) for i in range(n_pad) if indeg[i] == 0]
    heapq.heapify(heap)
    out = []
    inf = float("inf")
    while heap:
        k, t = heapq.heappop(heap)
        if k == inf:  # only -inf priorities left
            break
        out.append(t)
        for s in flat[(ends[t - 1] if t else 0):ends[t]]:
            d = indeg[s] - 1
            indeg[s] = d
            if d == 0:
                heapq.heappush(heap, (key[s], s))
    return np.array(out, dtype=np.int32)


def episode_plain(
    read_ids, read_t, read_sz, write_ids, write_sz, succ_ids,
    indeg0, prio, dur_cpu, dur_gpu, sizes, col_bits, host_col,
    is_gpu, valid_res, mem_col, link_grp, alpha, use_cp, ws_pref,
    noise, cap, bandwidth, *, n_steps: int, use_cap: bool, emit: bool,
):
    """The plain scan: ``(makespan, total_bytes, n_placed[, schedule])``,
    the schedule as a tuple of (B, n_steps) columns in
    :data:`SCHEDULE_COLUMNS` order."""
    dev = read_ids.device
    B, R = is_gpu.shape
    n_pad = read_ids.shape[0]
    s_pad = succ_ids.shape[1]
    n_u = col_bits.shape[0]
    nd1 = sizes.shape[0]
    f32, i32 = torch.float32, torch.int32
    inf = float("inf")
    rows = torch.arange(B, device=dev)[:, None]
    rr = torch.arange(R, device=dev)
    iota_n = torch.arange(n_pad, device=dev)
    iota_nd = torch.arange(nd1, device=dev)
    u_cols = torch.arange(n_u, device=dev)

    load = torch.zeros((B, R), dtype=f32, device=dev)
    tcount = torch.zeros((B, R), dtype=i32, device=dev)
    pready = torch.where(indeg0[:n_pad] == 0, prio, -inf).expand(B, n_pad).clone()
    ready_t = torch.zeros((B, n_pad + 1), dtype=f32, device=dev)
    indeg = indeg0.expand(B, n_pad + 1).clone()
    res_mask = torch.ones((B, nd1), dtype=i32, device=dev)  # everything starts on host
    touch = torch.full((B, n_u, nd1), -1, dtype=i32, device=dev) if use_cap else None
    resbytes = torch.zeros((B, n_u), dtype=f32, device=dev)
    writer = torch.full((B, nd1), -1, dtype=i32, device=dev)
    link_free = torch.zeros((B, R), dtype=f32, device=dev)  # per-link-group free clock
    total_b = torch.zeros(B, dtype=f32, device=dev)
    mk = torch.zeros(B, dtype=f32, device=dev)
    npl = torch.zeros(B, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    cols = []

    for k in range(n_steps):
        tb_in = total_b
        best = pready.max(dim=1).values
        t = torch.where(pready == best[:, None], iota_n, n_pad - 1).min(dim=1).values
        act = best > -inf  # padded steps: no-op

        rids = read_ids[t].long()
        prt, rsz = read_t[t], read_sz[t]
        wids = write_ids[t].long()
        wsz = write_sz[t]
        masks = res_mask.gather(1, rids.clamp(max=nd1 - 1))
        wmasks = res_mask.gather(1, wids.clamp(max=nd1 - 1))

        # score rows -----------------------------------------------------
        X = transfer_matrix_compact(masks, prt, col_bits, host_col)  # (B, n_u)
        w_hit = (wmasks[:, :, None] & col_bits[None, None, :]) != 0  # (B, w, n_u)
        aff = _row_sum(w_hit * wsz[:, :, None]) / bandwidth
        aff = torch.where(host_col[None, :], zero, aff)  # accel_write

        est = ready_t.gather(1, t[:, None])[:, 0]
        dur_r = torch.where(is_gpu, dur_gpu[t][:, None], dur_cpu[t][:, None])
        X_r = X.gather(1, mem_col.long())
        aff_r = aff.gather(1, mem_col.long())
        base = torch.maximum(est[:, None], load)
        score = fma_f32(use_cp[:, None], X_r, base) + dur_r
        score = fma_f32(-alpha[:, None], aff_r, score)
        score = torch.where(valid_res, score, inf)
        r_sel = _first_argmin(score)

        # work-stealing surrogate: spread by count, LIFO parent preference
        tscore = torch.where(valid_res, tcount.to(f32), inf)
        ws_sel = _first_argmin(tscore)
        pref = writer.gather(1, rids[:, :1].clamp(max=nd1 - 1))[:, 0].long()
        pref_c = pref.clamp(0, R - 1)
        pref_ok = (
            (pref >= 0)
            & valid_res.gather(1, pref_c[:, None])[:, 0]
            & (tscore.gather(1, pref_c[:, None])[:, 0] <= tscore.min(dim=1).values + 1.0)
        )
        ws_sel = torch.where(pref_ok, pref_c, ws_sel)
        r_sel = torch.where(ws_pref, ws_sel, r_sel)

        u = mem_col.gather(1, r_sel[:, None])[:, 0].long()
        dst_bit = col_bits[u]
        dst_host = host_col[u]

        # ground-truth advance: per-read hops to the chosen memory
        resident = (masks & dst_bit[:, None]) != 0
        nowhere = masks == 0
        on_host = (masks & 1) != 0
        hops = torch.where(
            resident | nowhere, 0.0,
            torch.where(dst_host[:, None] | on_host, 1.0, 2.0),
        ).to(f32)
        xfer_t = _row_sum(hops * prt)
        xfer_b = _row_sum(hops * rsz)

        dur_sel = dur_r.gather(1, r_sel[:, None])[:, 0]
        grp = link_grp.gather(1, r_sel[:, None])[:, 0].long()
        has_x = xfer_t > 0.0
        start = torch.maximum(est, load.gather(1, r_sel[:, None])[:, 0])
        start = torch.maximum(
            start, torch.where(has_x, link_free.gather(1, grp[:, None])[:, 0], zero)
        )
        sx = start + xfer_t
        fin = fma_f32(dur_sel, noise.gather(1, t[:, None])[:, 0], sx)
        grp_eff = torch.where(act & has_x, grp, R)  # out of range: dropped
        _put(link_free, rows, grp_eff[:, None], sx[:, None])

        # clock / ready-set updates --------------------------------------
        sel_hot = (rr[None, :] == r_sel[:, None]) & act[:, None]
        load = torch.where(sel_hot, fin[:, None], load)
        tcount = tcount + sel_hot.to(i32)
        npl = npl + act.to(i32)
        _put(pready, rows, torch.where(act, t, n_pad)[:, None],
             torch.full((B, 1), -inf, dtype=f32, device=dev))
        succs = succ_ids[t].long() + torch.where(act, 0, n_pad + s_pad)[:, None]
        _put(indeg, rows, succs, torch.full_like(indeg[:, :1], -1), op="add")
        now_ready = indeg.gather(1, succs.clamp(max=n_pad)) == 0
        _put(pready, rows, succs,
             torch.where(now_ready, prio[succs.clamp(max=n_pad - 1)], -inf), op="max")
        _put(ready_t, rows, succs, fin[:, None], op="max")
        mk = torch.maximum(mk, torch.where(act, fin, zero))
        total_b = total_b + torch.where(act, xfer_b, zero)

        # residency updates: reads land copies, writes invalidate ---------
        new_rmask = (
            masks
            | torch.where(hops > 0, dst_bit[:, None], 0)
            | (hops == 2).to(i32)
        )
        rids_eff = rids + torch.where(act, 0, nd1)[:, None]
        wids_eff = wids + torch.where(act, 0, nd1)[:, None]
        _put(res_mask, rows, rids_eff, new_rmask)
        _put(res_mask, rows, wids_eff, dst_bit[:, None])
        res_mask[:, nd1 - 1] = 1  # dummy slot stays host
        _put(writer, rows, wids_eff, r_sel.to(i32)[:, None])
        writer[:, nd1 - 1] = -1

        if use_cap:
            onehot_u = (u_cols[None, :] == u[:, None]).to(f32)
            rd_new = _row_sum(torch.where(hops > 0, rsz, zero))
            host_new = _row_sum(torch.where(hops == 2, rsz, zero))
            w_drop = _row_sum(torch.where(w_hit, wsz[:, :, None], zero))
            w_tot = _row_sum(wsz)
            delta = (
                onehot_u * (rd_new + w_tot)[:, None]
                - w_drop
                + host_col[None, :].to(f32) * host_new[:, None]
            )
            resbytes = resbytes + torch.where(act[:, None], delta, zero)
            touch_u = touch[rows[:, 0], u]  # (B, nd1): the chosen memory's row
            for ids in (rids_eff, wids_eff):
                _put(touch_u, rows, ids, torch.full_like(ids, k, dtype=i32))
            touch[rows[:, 0], u] = touch_u

            for _ in range(_K_EVICT):
                need = act & ~dst_host & (resbytes.gather(1, u[:, None])[:, 0] > cap)
                res_at = (res_mask & dst_bit[:, None]) != 0
                cand = res_at & (touch_u < k) & (sizes[None, :] > 0)
                key = torch.where(cand, touch_u, _NEVER)
                km = key.min(dim=1).values
                v = torch.where(key == km[:, None], iota_nd, nd1 - 1).min(dim=1).values
                can = need & (km < _NEVER)
                vsz = torch.where(can, sizes[v], zero)
                vmask = res_mask.gather(1, v[:, None])[:, 0]
                dirty = vmask == dst_bit  # sole device copy: write back
                total_b = total_b + torch.where(can & dirty, vsz, zero)
                newm = torch.where(can, (vmask | dirty.to(i32)) & ~dst_bit, vmask)
                _put(res_mask, rows, torch.where(can, v, nd1)[:, None], newm[:, None])
                resbytes = resbytes - onehot_u * vsz[:, None]

        if emit:
            xb = torch.where(act, xfer_b, zero)
            cols.append((t.to(i32), r_sel.to(i32), act, start, xfer_t, fin, xb,
                         (total_b - tb_in) - xb))

    if emit:
        return mk, total_b, npl, tuple(torch.stack(c, dim=1) for c in zip(*cols))
    return mk, total_b, npl


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
    fn = lib.repro_episode_scan
    fn.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_episode_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int64)]
    lib.repro_episode_plan.restype = ctypes.c_int
    _lib = lib
    return _build_log


def state_words(n_pad: int, nd1: int, n_u: int, use_cap: bool) -> int:
    """4-byte words of one configuration's scan state, which the kernel
    keeps in a global scratch buffer: ``ready_t`` (``n_pad``),
    ``res_mask`` and ``writer`` (``nd1`` each) and, with a capacity,
    ``touch`` (``n_u`` × ``nd1``). The ready set is not state: the kernel
    reads the plan's :func:`selection_order`."""
    return n_pad + 2 * nd1 + (n_u * nd1 if use_cap else 0)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def record_words(r_pad: int, w_pad: int, s_pad: int) -> int:
    """4-byte words of one task's record (:func:`task_records`): each
    section padded to 16 bytes (``record_words`` of
    csrc/sched_episode.cu)."""
    return 3 * _round4(r_pad) + 2 * _round4(w_pad) + _round4(s_pad) + 4


def warp_words(n_res: int, r_pad: int, w_pad: int, s_pad: int) -> int:
    """4-byte words of shared memory one configuration's warp uses
    (``warp_words`` of csrc/sched_episode.cu), each part 16-byte aligned:
    two row buffers (a task's record, the configuration's noise and the
    task's ready time), six a resource (clocks, machine rows, flags), the
    gathered masks of the reads and of the writes, and the successors'
    ready times."""
    rows = record_words(r_pad, w_pad, s_pad) + 4
    return 2 * rows + _round4(6 * n_res) + _round4(r_pad) + _round4(w_pad) + _round4(s_pad)


def task_records(args) -> torch.Tensor:
    """Each task's plan rows packed into one int32 record, on the inputs'
    device, so that the kernel fetches a task with one 16-byte copy a lane
    and folds four terms a 16-byte load: read ids, one-hop times and
    sizes, write ids and sizes, successors, then ``dur_cpu`` and
    ``dur_gpu`` (the floats' bits), each section zero-padded to 16
    bytes."""
    read_ids, read_t, read_sz, write_ids, write_sz, succ_ids = args[:6]
    dur_cpu, dur_gpu = args[8], args[9]
    i32 = torch.int32
    n_pad = read_ids.shape[0]

    def pad4(t: torch.Tensor) -> torch.Tensor:
        t = t.view(i32)
        extra = _round4(t.shape[1]) - t.shape[1]
        if not extra:
            return t
        return torch.cat([t, torch.zeros((n_pad, extra), dtype=i32, device=t.device)], dim=1)

    return torch.cat([pad4(read_ids), pad4(read_t), pad4(read_sz), pad4(write_ids),
                      pad4(write_sz), pad4(succ_ids),
                      pad4(torch.stack([dur_cpu, dur_gpu], dim=1))], dim=1)


def launch_plan(n_res: int, r_pad: int, w_pad: int, s_pad: int) -> Optional[Tuple[int, int]]:
    """(configurations a block, shared bytes a block) of the kernel's
    launch (``episode_plan`` of csrc/sched_episode.cu): :data:`WARPS`,
    fewer where their shared memory would not fit; None beyond
    :data:`MAX_RES` resources or where one warp's shared memory does not
    fit."""
    if n_res > MAX_RES:
        return None
    per = 4 * warp_words(n_res, r_pad, w_pad, s_pad)
    w = min(WARPS, SMEM_LIMIT // per)
    return (w, w * per) if w >= 1 else None


def launcher_plan(n_res: int, r_pad: int, w_pad: int, s_pad: int) -> Optional[Tuple[int, int]]:
    """The launcher's own plan (``repro_episode_plan``), for the card tests
    to hold against :func:`launch_plan`; None where it refuses."""
    build()
    out = (ctypes.c_int64 * 2)()
    if _lib.repro_episode_plan(n_res, r_pad, w_pad, s_pad, out) != 0:
        return None
    return int(out[0]), int(out[1])


@dataclass(frozen=True, eq=False)
class PlanTables:
    """What the kernel reads in place of the plan's rows, on the inputs'
    device: ``order`` (int32, at most ``n_pad`` tasks: the
    :func:`selection_order` of ``indeg0``, ``prio`` and ``succ_ids``) and
    ``records`` (:func:`task_records`). ``sources`` are the inputs
    ``read_ids`` .. ``dur_gpu`` they were derived from and ``versions``
    those tensors' in-place versions then: :func:`episode_scan` takes the
    tables only with these very tensors, unchanged."""

    order: torch.Tensor
    records: torch.Tensor
    sources: Tuple[torch.Tensor, ...]
    versions: Tuple[int, ...]

    def matches(self, args) -> bool:
        """Whether these tables were derived from ``args`` as they stand."""
        return all(a is s and a._version == v
                   for a, s, v in zip(args[:_N_SOURCES], self.sources, self.versions))


def _tables_from(args, order: np.ndarray) -> PlanTables:
    """The tables of ``args`` with ``order`` as their selection order; the
    caller vouches that ``order`` is the :func:`selection_order` of these
    inputs' ``indeg0``, ``prio`` and ``succ_ids`` (``episode_tables``
    passes the plan's, built from the arrays these tensors copy)."""
    sources = tuple(args[:_N_SOURCES])
    return PlanTables(
        order=torch.from_numpy(np.ascontiguousarray(order, dtype=np.int32)).to(args[0].device),
        records=task_records(args), sources=sources,
        versions=tuple(a._version for a in sources))


def plan_tables(args) -> PlanTables:
    """The tables of the 23 episode inputs ``args``, the selection order
    computed here from their own ``indeg0``, ``prio`` and ``succ_ids``
    (copied to the host once)."""
    indeg0, prio, succ_ids = (args[i].cpu().numpy() for i in (6, 7, 5))
    return _tables_from(args, selection_order(indeg0, prio, succ_ids))


def _check(args, n_steps: int, tables: Optional[PlanTables] = None) -> None:
    if len(args) != len(_ARG_NAMES):
        raise ValueError(f"the episode takes {len(_ARG_NAMES)} tensors, got {len(args)}")
    devices = {a.device for a in args}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    for name, a in zip(_ARG_NAMES, args):
        want = (torch.int32 if name in _INT_ARGS
                else torch.bool if name in _BOOL_ARGS else torch.float32)
        if a.dtype != want or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous {want}, got {a.dtype}")
    (read_ids, read_t, read_sz, write_ids, write_sz, succ_ids, indeg0, prio, dur_cpu,
     dur_gpu, sizes, col_bits, host_col, is_gpu, valid_res, mem_col, link_grp, alpha,
     use_cp, ws_pref, noise, cap, bandwidth) = args
    n_pad, r_pad = read_ids.shape
    B, R = is_gpu.shape
    n_u, nd1 = col_bits.shape[0], sizes.shape[0]
    shapes = {
        "read_t": (n_pad, r_pad), "read_sz": (n_pad, r_pad), "write_sz": write_ids.shape,
        "indeg0": (n_pad + 1,), "prio": (n_pad,), "dur_cpu": (n_pad,), "dur_gpu": (n_pad,),
        "host_col": (n_u,), "valid_res": (B, R), "mem_col": (B, R), "link_grp": (B, R),
        "alpha": (B,), "use_cp": (B,), "ws_pref": (B,), "noise": (B, n_pad), "cap": (B,),
        "bandwidth": (),
    }
    for name, a in zip(_ARG_NAMES, args):
        if name in shapes and tuple(a.shape) != tuple(shapes[name]):
            raise ValueError(f"{name} must have shape {tuple(shapes[name])}, got {tuple(a.shape)}")
    if write_ids.shape[0] != n_pad or succ_ids.shape[0] != n_pad or n_u > 31 or nd1 < 1:
        raise ValueError("malformed episode plan")
    if B < 1 or n_steps < 1:
        raise ValueError("the episode needs at least one configuration and one step")
    if tables is not None and not tables.matches(args):
        raise ValueError("the tables were derived from other inputs, or these were changed "
                         "in place since: derive them from these (plan_tables)")
    order = tables.order if tables is not None else None
    # ids past the state's edge are pads (dropped or clamped); the kernel
    # indexes with the rest, so they must be in range. One read of the
    # extremes (a single sync on the card).
    ranged = (("read_ids", read_ids, None), ("write_ids", write_ids, None),
              ("succ_ids", succ_ids, None), ("mem_col", mem_col, n_u), ("link_grp", link_grp, R),
              ("order", order, n_pad))
    ranged = [r for r in ranged if r[1] is not None and r[1].numel()]
    ext = (torch.stack([v for _, ids, _ in ranged for v in (ids.min(), ids.max())]).tolist()
           if ranged else [])
    for (name, _, hi), lo_v, hi_v in zip(ranged, ext[0::2], ext[1::2]):
        if lo_v < 0 or (hi is not None and hi_v >= hi):
            raise ValueError(f"{name} holds ids outside [0, {hi if hi is not None else 'inf'})")


def _launch(args, tables: PlanTables, *, n_steps: int, use_cap: bool, emit: bool):
    """One launch of the kernel on CUDA inputs and their ``tables``, which
    :func:`_check` passed: the kernel alone, no other work on the card."""
    build()
    dev = args[0].device
    read_ids, write_ids, succ_ids, sizes, col_bits, is_gpu = (
        args[0], args[3], args[5], args[10], args[11], args[13])
    n_pad, r_pad = read_ids.shape
    B, R = is_gpu.shape
    n_u, nd1 = col_bits.shape[0], sizes.shape[0]
    if launch_plan(R, r_pad, write_ids.shape[1], succ_ids.shape[1]) is None:
        raise ValueError(f"the kernel takes at most {MAX_RES} resources and a warp's shared "
                         f"memory within {SMEM_LIMIT} B: got {R} resources, "
                         f"{4 * warp_words(R, r_pad, write_ids.shape[1], succ_ids.shape[1])} B")
    f32, i32 = torch.float32, torch.int32
    mk = torch.empty(B, dtype=f32, device=dev)
    total_b = torch.empty(B, dtype=f32, device=dev)
    npl = torch.empty(B, dtype=i32, device=dev)
    schedule = tuple(
        torch.empty((B, n_steps), dtype=dt, device=dev)
        for dt in (i32, i32, torch.bool, f32, f32, f32, f32, f32)
    ) if emit else ()
    state = torch.empty(B * state_words(n_pad, nd1, n_u, use_cap), dtype=i32, device=dev)
    order = tables.order
    # the inputs the kernel reads itself: sizes .. bandwidth (the plan's
    # rows come packed in the records, the ready set as the order)
    ptrs = [a.data_ptr() for a in args[_N_SOURCES:]]
    ptrs += [mk.data_ptr(), total_b.data_ptr(), npl.data_ptr()]
    ptrs += [c.data_ptr() for c in schedule] if emit else [0] * len(SCHEDULE_COLUMNS)
    ptrs += [state.data_ptr(), order.data_ptr() if order.numel() else 0,
             tables.records.data_ptr()]
    dims = [B, n_pad, r_pad, write_ids.shape[1], succ_ids.shape[1], R, n_u, nd1,
            n_steps, int(use_cap), int(emit), order.numel()]
    err = _lib.repro_episode_scan(
        (ctypes.c_int64 * len(ptrs))(*ptrs), (ctypes.c_int * len(dims))(*dims),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"episode_scan kernel launch failed: CUDA error {err}")
    episode_scan.launches += 1
    return (mk, total_b, npl, schedule) if emit else (mk, total_b, npl)


def episode_scan(*args: torch.Tensor, n_steps: int, use_cap: bool, emit: bool,
                 tables: Optional[PlanTables] = None):
    """The episode over every configuration: the CUDA kernel on CUDA
    tensors (one launch), :func:`episode_plain` on CPU tensors. Takes the
    23 tensors of :func:`repro_torch.core.episode.episode_inputs`;
    returns ``(makespan, total_bytes, n_placed[, schedule])`` as
    :func:`episode_plain` does.

    ``tables`` are the inputs' :class:`PlanTables` (``run_episodes``
    passes the plan's, built once per device); they must have been derived
    from these very tensors, else the call is refused. Without them the
    card derives them here (:func:`plan_tables`: the order on the host,
    every call). The plain version selects step by step and reads no
    tables.
    """
    _check(args, n_steps, tables)
    dev = args[0].device
    if dev.type == "cpu":
        return episode_plain(*args, n_steps=n_steps, use_cap=use_cap, emit=emit)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if tables is None:
        tables = plan_tables(args)
    return _launch(args, tables, n_steps=n_steps, use_cap=use_cap, emit=emit)


episode_scan.launches = 0
