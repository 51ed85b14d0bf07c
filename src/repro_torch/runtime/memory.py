"""Capacity-bounded device memories: eviction, write-back, pressure.

Counterpart of ``repro.runtime.memory``. Opt-in (``mem_capacity`` > 0 on
the engine), so the unbounded model is untouched:

  * every device memory gets ``capacity`` bytes (host memory stays
    unbounded, the paper setup);
  * incoming copies *reserve* destination space before their hop is
    scheduled; when resident + reserved + incoming overflows, victims are
    evicted until it fits;
  * victim selection is ``lru`` (least-recently-touched) or ``affinity``
    (fewest remaining reader tasks first);
  * a victim whose *only* valid copy lives on the evicting memory is
    dirty: it is written back to host over the memory's link (charged as
    real transfer traffic, serialized ahead of the incoming copy) before
    the device copy is invalidated;
  * data a worker's head task is blocked on or currently reading is
    pinned and never victimized.

Policies observe the pressure through :func:`pressure_rows_for` (the
predicted eviction bytes a placement would force, as seconds over the
link), folded into the transfer rows by HEFT and DADA+CP and added to
every score matrix by :class:`repro_torch.sched.ScoreMatrixPolicy`.

Faults (:mod:`repro_torch.runtime.faults`) surface through the same
signal: :func:`pressure_rows_for` masks a detached resource's column to
+inf and adds the remaining notice window to a noticed one. A detach
forgets the dead memory's reservations (:meth:`MemoryManager.drop_mem`).
A capacity too small for the workload raises with the reference's byte
counts; the message names the ``mem_capacity`` argument, where the
reference names its environment variable.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.machine import HOST_MEM, MachineModel

EVICTION_POLICIES = ("lru", "affinity")


def predicted_eviction_bytes(resident_bytes, incoming_bytes, capacity):
    """Bytes that must be evicted from a memory holding ``resident_bytes``
    to fit ``incoming_bytes`` under ``capacity`` (elementwise, >= 0)."""
    free = np.maximum(0.0, np.asarray(capacity, dtype=np.float64) - resident_bytes)
    return np.maximum(0.0, np.asarray(incoming_bytes, dtype=np.float64) - free)


def pressure_rows_for(
    sim, tids: Sequence[int], resources, fault_mask: bool = True
) -> Optional[np.ndarray]:
    """The (ready × resources) pressure penalty for a simulation, or
    ``None`` when its device memories are unbounded and no resource is
    detached or noticed.

    The one lookup every consumer goes through: the
    ``ScoreMatrixPolicy.pressure_matrix`` hook, HEFT's and DADA+CP's
    transfer-row fold and the ``score_matrix`` views. On top of the
    memory pressure, a detached resource's column is +inf, so every
    consumer avoids dead devices through the channel it already reads,
    and a noticed resource's column (a detach announced, not yet fired)
    gets the remaining window, ``max(0, death_at - now)``: finite, and
    decaying to nothing at the death. ``fault_mask=False`` leaves both
    out, for DADA, which takes the dead and noticed resources as inputs
    of its search (an +inf row would poison its bound)."""
    memory = getattr(sim, "memory", None)
    rows = None
    if memory is not None and memory.bounded:
        rows = memory.pressure_rows(
            sim.arrays, tids, [r.mem for r in resources], sim.residency, sim.transfer_model
        )
    if fault_mask:
        faults = getattr(sim, "faults", None)
        if faults is not None and faults.any_dead:
            if rows is None:
                rows = np.zeros((len(tids), len(resources)), dtype=np.float64)
            dead = faults.dead_rids
            for j, r in enumerate(resources):
                if r.rid in dead:
                    rows[:, j] = np.inf
        if faults is not None and faults.noticed:
            if rows is None:
                rows = np.zeros((len(tids), len(resources)), dtype=np.float64)
            now = sim.now
            for j, r in enumerate(resources):
                pending = faults.noticed.get(r.rid)
                if pending is not None:
                    rows[:, j] += max(0.0, pending[1] - now)
    return rows


def fold_pressure(X, P: Optional[np.ndarray]):
    """Add penalty ``P`` into list-rows ``X`` elementwise (identity when
    ``P`` is None): the host fold that the scorer's ``x_bias`` section
    computes on the device, ``x + p`` entry by entry."""
    if P is None:
        return X
    return [
        [x + p for x, p in zip(xrow, prow)]
        for xrow, prow in zip(X, P.tolist())
    ]


def _segment_sum(values: np.ndarray, indptr: np.ndarray, n: int) -> np.ndarray:
    col = np.add.reduceat(np.append(values, 0.0), indptr[:-1])[:n]
    empty = indptr[:-1] == indptr[1:]
    if empty.any():
        col = np.where(empty, 0.0, col)
    return col


class MemoryManager:
    """Tracks residency and reservations per device memory and evicts on
    demand.

    Unbounded (``capacity`` falsy) instances are inert: ``bounded`` is
    False and the engine calls none of the hooks.
    """

    def __init__(self, machine: MachineModel, capacity: int = 0, policy: str = "lru") -> None:
        if policy not in EVICTION_POLICIES:
            raise ValueError(
                f"unknown eviction policy {policy!r} (choose from {EVICTION_POLICIES})"
            )
        self.capacity = int(capacity or 0)
        self.policy = policy
        self.bounded = self.capacity > 0
        self.transfers = None  # TransferEngine, wired by the engine
        device_mems = sorted({r.mem for r in machine.resources if r.mem != HOST_MEM})
        # per-device-memory state, keyed (GraphContext, data id); dict
        # order is the LRU order, least recently used first
        self._lru: Dict[int, Dict[Tuple[object, int], None]] = {mem: {} for mem in device_mems}
        self._pins: Dict[int, Dict[Tuple[object, int], int]] = {}
        self._resident: Dict[int, int] = {mem: 0 for mem in device_mems}
        self._reserved: Dict[int, int] = {mem: 0 for mem in device_mems}
        self._reservations: Dict[Tuple[object, str, int], int] = {}
        self.max_resident: Dict[int, int] = {mem: 0 for mem in device_mems}

    # ------------------------------------------------------------------
    # wiring
    def attach_ctx(self, ctx) -> None:
        """Bind a submitted graph: observe its residency, track remaining
        readers, and check that every task's working set fits."""
        if not self.bounded:
            return
        arr = ctx.arrays
        sizes = ctx.residency._sizes

        def observer(did, name, old, new, _ctx=ctx, _sizes=sizes):
            self._mask_changed(_ctx, did, old, new, _sizes)

        ctx.residency.observer = observer
        n_data = len(arr.data_names)
        if len(arr.read_ids):
            ctx.readers_left = np.bincount(arr.read_ids, minlength=n_data).tolist()
        else:
            ctx.readers_left = [0] * n_data
        # a task whose unique accessed bytes exceed the capacity can never
        # run: a configuration error at submit, not a livelock mid-run
        if arr.n_tasks:
            per_task = _segment_sum(
                np.where(arr.acc_first, arr.acc_sizes, 0.0), arr.acc_indptr, arr.n_tasks
            )
            worst = int(per_task.max())
            if worst > self.capacity:
                raise ValueError(
                    f"memory capacity {self.capacity} B is smaller than the "
                    f"largest task working set ({worst} B); raise mem_capacity"
                )

    def _mask_changed(self, ctx, did: int, old: int, new: int, sizes) -> None:
        changed = (old ^ new) & ~1  # host bit (0) is unbounded: ignored
        while changed:
            low = changed & -changed
            mem = low.bit_length() - 2
            key = (ctx, did)
            lru = self._lru.get(mem)
            if lru is None:  # a memory outside the machine: ignore
                changed ^= low
                continue
            if new & low:
                lru.pop(key, None)
                lru[key] = None  # most-recently-used end
                r = self._resident[mem] + sizes[did]
                self._resident[mem] = r
                if r > self.max_resident[mem]:
                    self.max_resident[mem] = r
            else:
                lru.pop(key, None)
                self._resident[mem] -= sizes[did]
            changed ^= low

    # ------------------------------------------------------------------
    # pins and touches (engine-driven lifecycle)
    def pin(self, ctx, did: int, mem: int) -> None:
        pins = self._pins.setdefault(mem, {})
        key = (ctx, did)
        pins[key] = pins.get(key, 0) + 1

    def unpin(self, ctx, did: int, mem: int) -> None:
        pins = self._pins.get(mem)
        if pins is None:
            return
        key = (ctx, did)
        n = pins.get(key, 0)
        if n <= 1:
            pins.pop(key, None)
        else:
            pins[key] = n - 1

    def touch(self, ctx, did: int, mem: int) -> None:
        lru = self._lru.get(mem)
        if lru is None:
            return
        key = (ctx, did)
        if key in lru:
            del lru[key]
            lru[key] = None

    def note_task_done(self, ctx, tid: int) -> None:
        rl = ctx.readers_left
        for did, _, _ in ctx.arrays.task_reads[tid]:
            rl[did] -= 1

    # ------------------------------------------------------------------
    # reservations (incoming transfers)
    def reserve(self, ctx, name: str, size: int, mem: int, now: float, protect=None) -> None:
        key = (ctx, name, mem)
        if key in self._reservations:
            return
        self.ensure_capacity(mem, size, now, ctx, protect)
        self._reservations[key] = size
        self._reserved[mem] += size

    def release(self, ctx, name: str, mem: int) -> None:
        size = self._reservations.pop((ctx, name, mem), None)
        if size is not None:
            self._reserved[mem] -= size

    def drop_mem(self, mem: int) -> None:
        """Forget every reservation toward ``mem``: its device detached, so
        the copies in flight there are dropped at landing, and their space
        claims must not outlive a re-attach."""
        for key in [k for k in self._reservations if k[2] == mem]:
            del self._reservations[key]
        if mem in self._reserved:
            self._reserved[mem] = 0

    # ------------------------------------------------------------------
    # eviction
    def ensure_capacity(self, mem: int, incoming: int, now: float, protect_ctx=None,
                        protect_dids=None) -> None:
        """Evict until ``incoming`` more bytes fit at ``mem``.

        Reservations are accounted, so evictions usually happen here and
        their write-backs queue ahead of the incoming copy on the link;
        the hard bound is on resident bytes. When nothing more is
        evictable, a reservation overshoot is tolerated (each copy
        re-ensures space when it lands); only a resident working set that
        cannot fit raises."""
        cap = self.capacity
        while self._resident[mem] + self._reserved[mem] + incoming > cap:
            victim = self._pick_victim(mem, protect_ctx, protect_dids)
            if victim is None:
                if self._resident[mem] + incoming > cap:
                    raise RuntimeError(
                        f"device memory {mem} over capacity: {cap} B "
                        f"capacity, {self._resident[mem]} B resident + "
                        f"{incoming} B incoming, and no evictable "
                        "(unpinned) data remains — mem_capacity is too "
                        "small for this workload"
                    )
                break  # over-reservation only: resolved as copies land
            self._evict(mem, victim, now)

    def _pick_victim(self, mem, protect_ctx, protect_dids):
        pins = self._pins.get(mem)
        best = None
        best_readers = None
        for key in self._lru[mem]:
            if pins and pins.get(key):
                continue
            ctx, did = key
            if protect_dids is not None and ctx is protect_ctx and did in protect_dids:
                continue
            if self.policy == "lru":
                return key  # first = least recently used
            readers = ctx.readers_left[did]
            if best is None or readers < best_readers:
                best, best_readers = key, readers
                if readers == 0:
                    break  # nobody pending: cannot do better
        return best

    def _evict(self, mem: int, key, now: float) -> None:
        ctx, did = key
        residency = ctx.residency
        name = ctx.arrays.data_names[did]
        size = residency._sizes[did]
        transfers = self.transfers
        metrics = transfers.metrics
        dirty = residency.mask_list[did] == 1 << (mem + 1)
        if dirty:
            # sole valid copy: written back before invalidation, on this
            # memory's link, so the copy that forced the eviction queues
            # behind it. The host copy is valid from the eviction instant,
            # as in the reference.
            transfers.one_hop(size, transfers.mem_link.get(mem), now, kind="writeback")
            residency.add_copy(name, HOST_MEM)
            metrics.n_writebacks += 1
            metrics.writeback_bytes += size
        residency.drop_copy(name, mem)  # the observer updates lru and resident
        metrics.n_evictions += 1
        if transfers.audit is not None:
            transfers.audit.log_evict(ctx.gid, name, mem, now, dirty)

    # ------------------------------------------------------------------
    # the pressure signal (policy-facing)
    def pressure_rows(self, arr, tids: Sequence[int], mems: Sequence[int], residency,
                      transfer_model) -> np.ndarray:
        """(len(tids) × len(mems)) predicted eviction seconds: entry (i, j)
        is the bytes placing task i on memory j would evict (its
        non-resident unique accessed bytes beyond the memory's free
        space) over the link bandwidth. Host columns are 0. The segment
        sums keep the reference's host ``np.add.reduceat`` form."""
        n, m = len(tids), len(mems)
        out = np.zeros((n, m), dtype=np.float64)
        if not self.bounded or n == 0:
            return out
        indptr, ids, sizes, first = arr.gather_csr(
            np.asarray(tids, dtype=np.int64),
            arr.acc_indptr, arr.acc_ids, arr.acc_sizes, arr.acc_first,
        )
        if len(ids) == 0:
            return out
        masks = residency.mask_of_ids(ids)
        weights = np.where(first, sizes, 0.0)
        bw = transfer_model.bandwidth
        cap = float(self.capacity)
        cols: Dict[int, np.ndarray] = {}
        for j, mem in enumerate(mems):
            if mem == HOST_MEM:
                continue
            col = cols.get(mem)
            if col is None:
                missing = (masks & (1 << (mem + 1))) == 0
                incoming = _segment_sum(np.where(missing, weights, 0.0), indptr, n)
                used = float(self._resident[mem] + self._reserved[mem])
                col = predicted_eviction_bytes(used, incoming, cap) / bw
                cols[mem] = col
            out[:, j] = col
        return out
