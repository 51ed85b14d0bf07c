"""The serving pool: a persistent ready pool with dirty-row rescoring.

Counterpart of ``repro.runtime.rescore``. In serving mode the engine hands
newly-ready tasks to :meth:`ServingScheduler.add_ready` instead of the
strategy's ``place``, and runs one :meth:`ServingScheduler.round` after
each simulated instant's events:

  * every ready task holds a :class:`PoolEntry` with its cached row
    ``row[j] = transfer(tid -> mem_j) + static_duration(tid, rid_j)
    (+ pressure)``: everything about the score that does not depend on the
    backlog;
  * rows are invalidated through the residency observer (a mask change on
    datum ``did`` dirties exactly the entries reading it, through the
    ``rev`` index) and through coarse epochs (faults, capacity pressure);
  * assignment pops a lazy min-heap of ``(min(row), gid, tid, version)``;
    the workers' backlog (``load_ts``) and the policy's fairness scale
    (``tenant_scale``, ``charge_tenant``) apply per pop.

``mode="full"`` runs the same round with every entry dirty every round
(the rebuild-everything baseline); both modes place alike.

Where the reference builds each dirty row on the host, graph by graph,
:meth:`ServingScheduler.round` scores all of a round's dirty rows, of
every tenant, in one :meth:`~repro_torch.core.backend.TorchScoringBackend.score_pool`
call on ``device``: one ``score_activation`` launch on the card. The
pressure rows (bounded memories, a dead or noticed resource) are added
after it, per graph, as the reference adds them: ``(x + d) + p``. Rounds
with fewer than ``min_wide`` dirty rows take the host rows, as HEFT and
DADA do below their ``min_wide``; the rows are the same either way.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..core.backend import TorchScoringBackend, check_min_wide
from .memory import pressure_rows_for

RESCORE_MODES = ("off", "full", "incremental")


class PoolEntry:
    """One ready task waiting in the serving pool."""

    __slots__ = ("ctx", "tid", "task", "row", "version")

    def __init__(self, ctx, tid: int, task) -> None:
        self.ctx = ctx
        self.tid = tid
        self.task = task
        self.row: Optional[List[float]] = None  # None: dirty, never built
        self.version = 0


class ServingScheduler:
    """Persistent ready pool with dirty-row rescoring, one per serving
    engine. ``device``: where each round's rows are scored (raises if it
    is ``cuda`` and no GPU is present); ``min_wide``: the fewest dirty rows
    a round scores on the device."""

    def __init__(self, mode: str, device="cuda", min_wide: int = 1) -> None:
        if mode not in RESCORE_MODES:
            raise ValueError(f"rescore mode must be one of {RESCORE_MODES}, got {mode!r}")
        self.mode = mode
        self.min_wide = check_min_wide(min_wide)
        self.backend = TorchScoringBackend(device)
        # (gid, tid) -> PoolEntry: the ready pool
        self.entries: Dict[Tuple[int, int], PoolEntry] = {}
        # gid -> ready tids
        self.by_graph: Dict[int, Set[int]] = {}
        # (gid, did) -> tids reading did: residency-driven invalidation
        self.rev: Dict[Tuple[int, int], Set[int]] = {}
        self.dirty: Set[Tuple[int, int]] = set()
        # lazy min-heap of (best row score, gid, tid, version); stale
        # versions are skipped on pop
        self.heap: List[Tuple[float, int, int, int]] = []
        # bumped by the engine on fault events (liveness changed)
        self.epoch = 0
        self._seen_epoch = 0
        self.rows_built = 0  # rows (re)built: what incremental mode shrinks
        self.n_rounds = 0

    # ------------------------------------------------------------------
    def watch_ctx(self, ctx) -> None:
        """Chain onto ``ctx``'s residency observer (after the memory
        layer's, if any): a mask change on datum ``did`` dirties exactly
        the pool entries that read it."""
        prev = ctx.residency.observer
        gid = ctx.gid
        rev = self.rev
        dirty = self.dirty

        def observer(did, name, old, new, _prev=prev, _gid=gid):
            if _prev is not None:
                _prev(did, name, old, new)
            tids = rev.get((_gid, did))
            if tids:
                for tid in tids:
                    dirty.add((_gid, tid))

        ctx.residency.observer = observer

    def add_ready(self, engine, ctx, ready) -> None:
        """Admit newly-ready tasks into the pool (their rows are built at
        the next round)."""
        gid = ctx.gid
        entries = self.entries
        by_graph = self.by_graph.setdefault(gid, set())
        rev = self.rev
        dirty = self.dirty
        task_reads = ctx.arrays.task_reads
        for task in ready:
            tid = task.tid
            key = (gid, tid)
            entries[key] = PoolEntry(ctx, tid, task)
            by_graph.add(tid)
            dirty.add(key)
            for did, _name, _size in task_reads[tid]:
                rev.setdefault((gid, did), set()).add(tid)

    def _remove(self, key: Tuple[int, int]) -> None:
        entry = self.entries.pop(key)
        gid, tid = key
        tids = self.by_graph.get(gid)
        if tids is not None:
            tids.discard(tid)
            if not tids:
                del self.by_graph[gid]
        rev = self.rev
        for did, _name, _size in entry.ctx.arrays.task_reads[tid]:
            bucket = rev.get((gid, did))
            if bucket is not None:
                bucket.discard(tid)
                if not bucket:
                    del rev[(gid, did)]
        self.dirty.discard(key)

    # ------------------------------------------------------------------
    def _rebuild(self, engine, keys) -> None:
        """(Re)build the rows of ``keys``: scored together in one
        ``score_pool`` call (one launch on the card) when there are at
        least ``min_wide`` of them, else on the host graph by graph; then
        each graph's pressure rows added, in sorted ``(gid, tid)`` order."""
        entries = self.entries
        resources = engine.machine.resources
        heap = self.heap
        by_gid: Dict[int, List[PoolEntry]] = {}
        for key in sorted(keys):
            entry = entries.get(key)
            if entry is not None:
                by_gid.setdefault(key[0], []).append(entry)
        gids = sorted(by_gid)
        groups = [(by_gid[gid][0].ctx, [e.tid for e in by_gid[gid]]) for gid in gids]
        n_rows = sum(len(tids) for _, tids in groups)
        C = None
        if n_rows >= self.min_wide:  # min_wide >= 1
            C = self.backend.score_pool(groups, resources, engine.transfer_model)
        at = 0
        for gid, (ctx, tids) in zip(gids, groups):
            engine._set_ctx(ctx)
            n = len(tids)
            if C is None:
                X = engine.transfer_model.task_input_transfer_rows(
                    ctx.arrays, tids, engine._mem_of, ctx.residency
                )
                rid_static = ctx.rid_static
                base = [[xrow[j] + rid_static[j][tid] for j in range(len(xrow))]
                        for xrow, tid in zip(X, tids)]
            else:
                base = C[at:at + n]
                at += n
            P = pressure_rows_for(engine, tids, resources)
            if P is not None:
                rows = (np.asarray(base, dtype=np.float64) + P).tolist()
            else:
                rows = base.tolist() if C is not None else base
            for entry, row in zip(by_gid[gid], rows):
                entry.row = row
                entry.version += 1
                self.rows_built += 1
                heapq.heappush(heap, (min(row), gid, entry.tid, entry.version))

    def round(self, engine) -> None:
        """One placement round over the pool at ``engine.now``.

        Invalidation rules, coarsest first: 1. ``mode="full"``: every row,
        every round; 2. bounded memories or an open notice window: the
        pressure term moves with the clock, so every row; 3. a fault event
        since the last round (the epoch moved): every row, once; 4. else
        the rows the residency observer and ``add_ready`` marked dirty.
        """
        if not self.entries:
            self.dirty.clear()
            return
        self.n_rounds += 1
        faults = engine.faults
        if (
            self.mode == "full"
            or engine._bounded
            or (engine._faults_on and faults.noticed)
            or self.epoch != self._seen_epoch
        ):
            self.dirty.update(self.entries)
        self._seen_epoch = self.epoch
        if self.dirty:
            # drained in place: the residency observers hold this set
            dirty = tuple(self.dirty)
            self.dirty.clear()
            self._rebuild(engine, dirty)

        entries = self.entries
        heap = self.heap
        workers = engine.workers
        load_ts = engine.load_ts
        now = engine.now
        faults_on = engine._faults_on
        alive = faults.alive
        noticed = faults.noticed
        strategy = engine.strategy
        scale_fn = getattr(strategy, "tenant_scale", None)
        charge = getattr(strategy, "charge_tenant", None)
        heappop = heapq.heappop
        while heap:
            _rank, gid, tid, version = heap[0]
            entry = entries.get((gid, tid))
            if entry is None or entry.version != version:
                heappop(heap)  # stale: assigned or rebuilt since pushed
                continue
            ctx = entry.ctx
            scale = 1.0 if scale_fn is None else float(scale_fn(engine, ctx))
            row = entry.row
            best_j = -1
            best = 0.0
            for j, w in enumerate(workers):
                if w.queue:
                    continue  # one queued task per worker per pass
                if faults_on and (not alive[j] or j in noticed):
                    continue
                lt = load_ts[j]
                backlog = lt - now if lt > now else 0.0
                s = row[j] + backlog * scale
                if best_j < 0 or s < best:
                    best_j = j
                    best = s
            if best_j < 0:
                # every eligible worker took a task this round: the entry
                # stays ranked for the next round
                break
            heappop(heap)
            dur = ctx.rid_static[best_j][tid]
            lt = load_ts[best_j]
            load_ts[best_j] = (lt if lt > now else now) + dur
            if charge is not None:
                charge(ctx, dur)
            self._remove((gid, tid))
            engine._set_ctx(ctx)
            engine.push(entry.task, best_j)
