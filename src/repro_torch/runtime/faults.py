"""Resource dynamics: detach/attach faults, recovery modes, seeded churn.

Counterpart of ``repro.runtime.faults``. The paper evaluates HEFT and
DADA on a fixed machine; this layer makes the machine dynamic. A
resource can **detach** (spot preemption, hardware fault) and later
**attach** again; the engine routes both through its event loop, so
faults interleave deterministically with transfers and completions.

Two recovery modes:

  * ``drain`` — stop dispatching to the device and let its running task
    finish; queued tasks are re-activated on the survivors and the
    device's data is salvaged to host;
  * ``kill`` — the running task is aborted (its partial execution is
    wasted work, ``metrics.wasted_s``) and re-activated on the survivors
    with the queued tasks. Data is salvaged either way, but a copy in
    flight toward the dead memory is invalidated: each memory carries an
    epoch, bumped at detach, and a landing with a stale epoch is dropped.

Evacuation prices like a dirty eviction's write-back: each sole copy on
the dead memory is written back over its link (charged as transfer
traffic) before every device copy is dropped, so a rejoined device starts
affinity-cold and no byte is lost.

Fault sources (all three post the engine's ``"fault"`` event):

  * programmatic — ``engine.inject("detach", rid, at=..., mode=...)``;
  * seeded churn — ``churn=rate`` on the engine detaches and attaches
    random accelerators with exponential inter-arrival times (rate events
    per simulated second), drawn from a generator of its own, so a run
    without churn consumes the engine's seeded stream untouched;
  * trace replay — ``fault_trace=path.jsonl``
    (:mod:`repro_torch.runtime.traces`).

A **notice** (``notice_s`` > 0) announces a detach ahead of time: the
worker starts no new work, its sole copies are replicated to host at
once, most pending readers first, and policies see a finite penalty on
its column (the remaining window).

Policies observe faults through the shared pressure channel
(:func:`repro_torch.runtime.memory.pressure_rows_for` masks dead columns
to +inf and adds the notice penalty): HEFT folds it into its transfer
rows through the scorer's ``x_bias``, the score-matrix policies add it to
their scores, and DADA takes the dead and noticed resources as inputs of
its placement (``dada_place``). ``ws`` is covered by the engine: a push
aimed at a dead worker goes to the next alive one, and dead or noticed
workers neither start work nor steal. Observers subscribed with
:meth:`FaultManager.subscribe` see every transition.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.machine import HOST_MEM, MachineModel

from .traces import FAULT_EVENTS, FAULT_MODES, FaultEvent

# Dedicated churn stream key: keeps the churn generator's draws disjoint
# from the engine's seeded noise stream for every engine seed.
_CHURN_STREAM = 0xFA017


class FaultManager:
    """Per-engine resource liveness plus the detach/attach procedures.

    Inert (``active`` False) until a fault source registers; the engine's
    hot paths check one boolean before touching any of this state, so the
    zero-fault bit-for-bit equivalence contract is preserved.
    """

    def __init__(self, machine: MachineModel, mode: str = "drain") -> None:
        if mode not in FAULT_MODES:
            raise ValueError(
                f"unknown fault mode {mode!r} (choose from {FAULT_MODES})"
            )
        self.machine = machine
        self.default_mode = mode
        n = len(machine.resources)
        self.alive: List[bool] = [True] * n
        self.n_alive = n
        self.dead_rids: frozenset = frozenset()
        self.any_dead = False
        self.dead_mems: set = set()
        # per-memory detach epoch: transfers record the destination epoch
        # at request time; a landing with a stale epoch is dropped
        self.mem_epoch: dict = {}
        self.active = False
        self.history: List[FaultEvent] = []
        # preemption notices: rid -> (t_notice, death_at). A noticed
        # worker is still alive (its running task drains) but the engine
        # starts no new work on it and policies see a finite decaying
        # pressure penalty on its column (pressure_rows_for).
        self.noticed: Dict[int, Tuple[float, float]] = {}
        self.churn_rate = 0.0
        self.churn_notice_s = 0.0
        self.churn_mode = mode
        self._rng: Optional[np.random.Generator] = None
        self._accel_rids = [r.rid for r in machine.resources if r.is_accelerator]
        self._observers: List[Callable] = []

    # ------------------------------------------------------------------
    def subscribe(self, callback: Callable) -> None:
        """Register ``callback(engine, event, rid, mode)`` for every
        detach/attach transition (e.g. an elastic re-planner)."""
        self._observers.append(callback)

    def _notify(self, engine, event: str, rid: int, mode: Optional[str]) -> None:
        for cb in self._observers:
            cb(engine, event, rid, mode)

    # ------------------------------------------------------------------
    def redirect(self, rid: int) -> int:
        """The next alive rid after ``rid`` (cyclic): the engine's backstop
        so fault-oblivious strategies never enqueue onto a dead worker."""
        n = len(self.alive)
        for k in range(1, n + 1):
            j = (rid + k) % n
            if self.alive[j]:
                return j
        raise RuntimeError("no alive workers to redirect to")

    def _mark(self, rid: int, is_alive: bool) -> None:
        self.alive[rid] = is_alive
        self.n_alive += 1 if is_alive else -1
        self.dead_rids = frozenset(
            i for i, a in enumerate(self.alive) if not a
        )
        self.any_dead = bool(self.dead_rids)

    # ------------------------------------------------------------------
    def enable_churn(
        self,
        rate: float,
        seed: int,
        mode: Optional[str] = None,
        notice_s: float = 0.0,
    ) -> None:
        if rate < 0:
            raise ValueError(f"churn rate must be >= 0, got {rate}")
        if notice_s < 0:
            raise ValueError(f"notice_s must be >= 0, got {notice_s}")
        if mode is not None and mode not in FAULT_MODES:
            raise ValueError(
                f"unknown fault mode {mode!r} (choose from {FAULT_MODES})"
            )
        self.churn_rate = float(rate)
        self.churn_notice_s = float(notice_s)
        self.churn_mode = mode or self.default_mode
        self._rng = np.random.default_rng((int(seed) & 0xFFFFFFFF, _CHURN_STREAM))
        if rate > 0:
            self.active = True

    def schedule_churn(self, engine) -> None:
        """Post the first churn tick (the run loop calls this at start)."""
        if self.churn_rate > 0:
            self._post_tick(engine)

    def _post_tick(self, engine) -> None:
        dt = float(self._rng.exponential(1.0 / self.churn_rate))
        engine.events.post(engine.now + dt, "fault", ("churn", -1, None))

    def _churn_tick(self, engine) -> None:
        # stop self-rescheduling once every submitted graph finished —
        # otherwise the churn stream would keep the event loop alive forever
        if all(ctx.n_done >= ctx.n_tasks for ctx in engine._ctxs):
            return
        rng = self._rng
        # a noticed worker is already condemned: it is excluded from the
        # detach pool (no double-notice) and counted as gone for the
        # last-worker guard, so a delayed churn death can never strand
        # the machine with zero alive workers
        alive_g = [
            r for r in self._accel_rids
            if self.alive[r] and r not in self.noticed
        ]
        dead_g = [r for r in self._accel_rids if not self.alive[r]]
        # never detach the last alive worker; only accelerators churn
        # (CPUs are the stable host pool, the spot-instance setup)
        can_detach = bool(alive_g) and self.n_alive - len(self.noticed) > 1
        if dead_g and (not can_detach or rng.random() < 0.5):
            self.attach(engine, dead_g[int(rng.integers(len(dead_g)))])
        elif can_detach:
            rid = alive_g[int(rng.integers(len(alive_g)))]
            ns = self.churn_notice_s
            if ns > 0:
                # spot-style advance warning: the notice lands now, the
                # death is posted ns seconds out
                death_at = engine.now + ns
                self.notice(engine, rid, death_at, self.churn_mode)
                engine.events.post(
                    death_at, "fault", ("detach", rid, self.churn_mode)
                )
            else:
                self.detach(engine, rid, self.churn_mode)
        self._post_tick(engine)

    # ------------------------------------------------------------------
    def handle(self, engine, action: str, rid: int, mode: Optional[str]) -> None:
        """Dispatch one ``"fault"`` event from the engine's run loop."""
        if action == "churn":
            self._churn_tick(engine)
        elif action == "detach":
            self.detach(engine, rid, mode)
        elif action == "attach":
            self.attach(engine, rid)
        elif action == "notice":
            # the mode slot carries (recovery mode, scheduled death time)
            m, death_at = mode
            self.notice(engine, rid, death_at, m)
        else:  # pragma: no cover - engine only posts the four above
            raise ValueError(f"unknown fault action {action!r}")

    # ------------------------------------------------------------------
    def notice(
        self, engine, rid: int, death_at: float, mode: Optional[str] = None
    ) -> None:
        """Deliver an advance warning: ``rid`` will detach at ``death_at``.

        The worker stays alive (its running task drains) but the engine
        starts no new work on it, and if its memory dies with it every
        sole-copy datum is proactively replicated to host *now* — ranked
        most-pending-readers first, the same affinity signal eviction
        uses — instead of on the critical recovery path at death.
        Idempotent per window: a second notice for a pending death is a
        no-op.
        """
        self._check_rid(rid)
        if not self.alive[rid] or rid in self.noticed:
            return
        now = engine.now
        self.noticed[rid] = (now, float(death_at))
        engine.metrics.n_notices += 1
        if engine.audit is not None:
            engine.audit.log_notice(
                now, rid, mode or self.default_mode, float(death_at)
            )
        # proactive replication only helps when the memory dies with the
        # worker (same sharing test the detach salvage uses; co-noticed
        # sharers are condemned too, so they do not count as survivors)
        mem = engine._mem_of[rid]
        shared = any(
            self.alive[r.rid] and r.rid not in self.noticed
            for r in self.machine.resources
            if r.mem == mem and r.rid != rid
        )
        if mem != HOST_MEM and not shared:
            self._replicate(engine, mem)
        self._notify(engine, "notice", rid, mode)

    def _pending_readers(self, ctx, dids: Sequence[int]) -> Dict[int, int]:
        """Pending-reader counts for ``dids`` (the affinity signal).

        Capacity-bounded runs maintain ``ctx.readers_left`` incrementally;
        unbounded runs compute it here by scanning the not-yet-done tasks
        (notices are rare — this is off every hot path).
        """
        if ctx.readers_left:
            return {d: ctx.readers_left[d] for d in dids}
        want = set(dids)
        counts = {d: 0 for d in dids}
        done = ctx.done
        task_reads = ctx.arrays.task_reads
        for t in ctx.graph.tasks:
            if done[t.tid]:
                continue
            for did, _, _ in task_reads[t.tid]:
                if did in want:
                    counts[did] += 1
        return counts

    def _replicate(self, engine, mem: int) -> None:
        """Replicate every sole-copy datum on ``mem`` to host, most
        pending readers first (inside the notice window, before death)."""
        bit = 1 << (mem + 1)
        metrics = engine.metrics
        transfers = engine.transfers
        group = transfers.mem_link.get(mem)
        now = engine.now
        audit = engine.audit
        for ctx in engine._ctxs:
            residency = ctx.residency
            mask_list = residency.mask_list
            names = ctx.arrays.data_names
            sizes = residency._sizes
            sole = [
                did for did in range(len(names)) if mask_list[did] == bit
            ]
            if not sole:
                continue
            readers = self._pending_readers(ctx, sole)
            sole.sort(key=lambda d: (-readers[d], d))
            for did in sole:
                # same pricing (and the same immediate host-copy validity
                # simplification) as the write-back/evacuation path
                transfers.one_hop(sizes[did], group, now, kind="proactive")
                residency.add_copy(names[did], HOST_MEM)
                metrics.n_proactive += 1
                metrics.proactive_bytes += sizes[did]
                if audit is not None:
                    audit.log_landing(
                        ctx.gid, names[did], HOST_MEM, now, True, "proactive"
                    )

    # ------------------------------------------------------------------
    def detach(self, engine, rid: int, mode: Optional[str] = None) -> None:
        """Remove resource ``rid`` from the machine at ``engine.now``.

        Idempotent: detaching an already-dead resource is a no-op.
        Detaching the last alive worker raises (the run could never
        finish).
        """
        self._check_rid(rid)
        if not self.alive[rid]:
            return
        if self.n_alive <= 1:
            raise RuntimeError(
                f"cannot detach rid {rid}: it is the last alive worker"
            )
        mode = mode or self.default_mode
        if mode not in FAULT_MODES:
            raise ValueError(
                f"unknown fault mode {mode!r} (choose from {FAULT_MODES})"
            )
        now = engine.now
        self._mark(rid, False)
        # a noticed death closes its window: record the realized warning
        # time so a saved history replays the notice at the same instant
        pending = self.noticed.pop(rid, None)
        ns = None if pending is None else now - pending[0]
        self.history.append(FaultEvent(now, "detach", rid, mode, ns))
        if engine.audit is not None:
            engine.audit.log_fault(now, "detach", rid, mode)
        metrics = engine.metrics
        metrics.n_detaches += 1

        # 1) strip the worker: queued tasks will be re-activated on the
        # survivors; under kill the running task is aborted and requeued
        # too (its partial execution is wasted work)
        w = engine.workers[rid]
        requeue = list(w.queue)
        w.queue.clear()
        engine._unpin_worker(w)
        w.blocked_on = 0
        if mode == "kill" and w.running is not None:
            task = w.running
            ctx = engine._ctx_of[id(task)]
            # bump the attempt counter: the already-posted "done" event for
            # this execution is recognized as stale and discarded at fire
            ctx.attempt[task.tid] += 1
            metrics.n_killed += 1
            metrics.wasted_s += now - w.run_start
            w.running = None
            requeue.insert(0, task)

        # 2) salvage the device memory (no alive resource left on it):
        # sole-copy (dirty) data is written back to host over the memory's
        # link before every device copy is dropped, then pending landings
        # are invalidated via the memory epoch
        mem = engine._mem_of[rid]
        shared = any(
            self.alive[r.rid]
            for r in self.machine.resources
            if r.mem == mem and r.rid != rid
        )
        if mem != HOST_MEM and not shared:
            self.dead_mems.add(mem)
            self.mem_epoch[mem] = self.mem_epoch.get(mem, 0) + 1
            self._evacuate(engine, mem)
            for ctx in engine._ctxs:
                inflight = ctx.inflight
                for name in list(inflight):
                    flights = inflight[name]
                    flights.pop(mem, None)
                    if not flights:
                        del inflight[name]
            if engine.memory.bounded:
                engine.memory.drop_mem(mem)

        # 3) scrub the waiting index: nobody is left to wake on the dead
        # memory, and the dead rid must not be double-woken if it re-attaches
        mem_gone = mem != HOST_MEM and not shared
        for ctx in engine._ctxs:
            waiting = ctx.waiting
            if mem_gone:
                for key in [k for k in waiting if k[1] == mem]:
                    del waiting[key]
            for key, rids in list(waiting.items()):
                if rid in rids:
                    rids[:] = [r for r in rids if r != rid]
                    if not rids:
                        del waiting[key]

        # 4) re-activate the stripped work on the survivors (strategy
        # placement, exactly like a fresh activation)
        if requeue:
            metrics.n_requeued += len(requeue)
            by_ctx: List = []
            seen = {}
            for task in requeue:
                ctx = engine._ctx_of[id(task)]
                bucket = seen.get(id(ctx))
                if bucket is None:
                    bucket = (ctx, [])
                    seen[id(ctx)] = bucket
                    by_ctx.append(bucket)
                bucket[1].append(task)
            for ctx, tasks in by_ctx:
                engine._place_ready(ctx, tasks, None)
        if engine._steal_on:
            engine._steal_round()
        self._notify(engine, "detach", rid, mode)

    # ------------------------------------------------------------------
    def attach(self, engine, rid: int) -> None:
        """Rejoin resource ``rid`` at ``engine.now``, affinity-cold.

        Idempotent: attaching an alive resource is a no-op. A still-
        draining worker keeps its running task; its memory was salvaged
        at detach, so the device starts with no resident data either way.
        """
        self._check_rid(rid)
        if self.alive[rid]:
            return
        now = engine.now
        self._mark(rid, True)
        self.noticed.pop(rid, None)  # a rejoining device owes no death
        self.history.append(FaultEvent(now, "attach", rid, None))
        if engine.audit is not None:
            engine.audit.log_fault(now, "attach", rid, None)
        engine.metrics.n_attaches += 1
        mem = engine._mem_of[rid]
        self.dead_mems.discard(mem)
        w = engine.workers[rid]
        if w.running is None:
            engine.load_ts[rid] = now
        else:
            engine.load_ts[rid] = max(engine.load_ts[rid], now)
        if engine._steal_on:
            engine._steal_round()
        self._notify(engine, "attach", rid, None)

    # ------------------------------------------------------------------
    def _check_rid(self, rid: int) -> None:
        if not isinstance(rid, (int, np.integer)) or isinstance(rid, bool):
            raise TypeError(f"rid must be an integer, got {rid!r}")
        if not 0 <= rid < len(self.alive):
            raise ValueError(
                f"rid {rid} out of range for a machine with "
                f"{len(self.alive)} resources"
            )

    def _evacuate(self, engine, mem: int) -> None:
        bit = 1 << (mem + 1)
        metrics = engine.metrics
        transfers = engine.transfers
        group = transfers.mem_link.get(mem)
        now = engine.now
        for ctx in engine._ctxs:
            residency = ctx.residency
            mask_list = residency.mask_list
            names = ctx.arrays.data_names
            sizes = residency._sizes
            for did in range(len(names)):
                m = mask_list[did]
                if not m & bit:
                    continue
                name = names[did]
                if m == bit:
                    # sole valid copy lives here: dirty w.r.t. host —
                    # write back over this memory's link (the preemption
                    # notice window), charged as real transfer traffic
                    transfers.one_hop(sizes[did], group, now, kind="evacuate")
                    residency.add_copy(name, HOST_MEM)
                    metrics.n_evacuations += 1
                    metrics.evacuated_bytes += sizes[did]
                residency.drop_copy(name, mem)
