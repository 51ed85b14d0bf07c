"""The event-driven XKaapi-like runtime engine.

Reproduces the paper's execution flow (§2.1-2.2):
  * each worker owns a local ready-queue (pop / push / steal),
  * completing a task triggers ``activate`` on its newly-ready successors —
    this is where the scheduling strategy runs,
  * transfers to/from accelerator memories are prefetched when a task is
    pushed, overlap with computation, and contend on shared PCIe-switch
    links (FIFO per link group — :mod:`repro_torch.runtime.transfers`),
  * idle workers emit steal requests to a randomly selected victim (enabled
    by strategies with ``allow_steal``: the ``ws`` baseline),
  * the runtime observes real (noisy) durations and feeds the history-based
    performance model, which therefore calibrates online (§2.3).

Counterpart of ``repro.runtime.engine``, with the reference's options as
arguments:

  * capacity-bounded memories: ``mem_capacity`` bytes per device memory
    (0, the default: unbounded) and ``eviction`` (``"lru"`` or
    ``"affinity"``), see :mod:`repro_torch.runtime.memory`. Every memory
    hook sits behind the ``bounded`` flag;
  * faults (:mod:`repro_torch.runtime.faults`): :meth:`Engine.inject`,
    :meth:`Engine.replay_trace` or ``fault_trace`` (a JSONL trace), seeded
    ``churn`` (events a simulated second), the recovery ``fault_mode``
    (``"drain"`` or ``"kill"``) and ``notice_s``, the preemption notice
    ahead of each detach. Every fault hook sits behind one flag that only
    a fault source sets, and pushes aimed at a dead worker go to the next
    alive one;
  * flaky links (:mod:`repro_torch.runtime.transfers`): ``link_flake``,
    the chance that a demand hop fails, retried ``retry_max`` times with
    backoff from ``backoff_s``;
  * stale-transfer cancellation: with ``cancel_stale=True`` a copy in
    flight when its data is overwritten is dropped at its landing (logged
    ``"stale"``) instead of landing as a valid copy;
  * serving mode (:mod:`repro_torch.runtime.rescore`, ``rescore="full"``
    or ``"incremental"``): a shared ready pool replaces the strategy's
    per-activation ``place``. Events of one simulated instant are drained
    together and one placement round runs per instant; each round's dirty
    rows, of every tenant, are scored in one ``score_activation`` launch
    on ``device`` (rounds with fewer than ``min_wide`` rows take the host
    rows). ``admission`` (``"reject"`` or ``"defer"``, retried every
    ``admit_defer_s``) turns away tenants whose working set does not fit
    the device memories left.

The defaults are the reference's (``churn=0.0``, ``fault_mode="drain"``,
``fault_trace=None``, ``notice_s=0.0``, ``link_flake=0.0``,
``retry_max=3``, ``backoff_s=1e-4``); with them a run takes the code path
it took before the hooks existed. Any number of graphs may be submitted,
each with a tenant ``priority`` that the ``priority`` and ``wfq`` policies
read: before :meth:`Engine.run` their roots are placed in submit order when
the run starts; with ``at=`` (or during the run) the arrival is an event at
that simulated time, so tenant graphs stream into a live machine.

``audit=True`` records the run in a :class:`repro_torch.verify.AuditLog`
(``engine.audit``): the machine, every submitted graph's accesses, each
execution, each link hop and each landing, with the same records in the
same order as ``repro``'s engine on the same run. Every hook sits behind
an ``is not None`` check, so an audit-off run takes the code path it
took before the hooks existed.

Determinism: all randomness flows through one seeded numpy Generator (the
per-task duration noise of each graph is drawn, in tid order, when the
graph is submitted; each steal draws its victim from the same stream).
Event posting order, seeded-stream consumption and IEEE operation order
are those of ``repro``'s engine, so a run here is bit-for-bit the
reference run.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np

from ..core.dag import GraphArrays, Task, TaskGraph
from ..core.machine import HOST_MEM, MachineModel, ResourceClass
from ..core.perfmodel import (
    ClassPredictor,
    HistoryPerfModel,
    Residency,
    TransferModel,
)
from ..verify.audit import AuditLog
from .events import EventQueue
from .faults import FaultManager
from .load import ADMISSION_MODES
from .memory import MemoryManager
from .metrics import Metrics, ScheduledInterval, SimResult
from .queues import Worker, eligible_victims
from .rescore import RESCORE_MODES, ServingScheduler
from .traces import FAULT_EVENTS, FAULT_MODES, load_trace
from .transfers import TransferEngine


class Strategy:
    """Scheduling strategy interface: placement happens in ``place``."""

    name = "base"
    allow_steal = False
    owner_lifo = False

    def init(self, sim) -> None:
        pass

    def place(
        self, sim, ready: List[Task], src: Optional[int]
    ) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class GraphContext:
    """Per-submitted-graph state."""

    __slots__ = (
        "gid", "graph", "arrays", "residency", "inflight", "waiting",
        "noise_mult", "preds", "succ", "done", "n_done", "n_tasks",
        "rid_static", "predictors", "finish", "intervals", "submit_at",
        "data_version", "readers_left", "priority", "attempt",
        "ws_bytes", "arrived", "admitted", "rejected", "admit_at",
    )

    def __init__(self, gid: int, graph: TaskGraph) -> None:
        self.gid = gid
        self.graph = graph
        self.arrays: GraphArrays = graph.arrays()
        self.residency = Residency()
        self.residency.attach(self.arrays)
        # all application data starts in host memory (paper setup)
        self.residency.initialize(self.arrays.data_names, HOST_MEM)
        # in-flight transfers indexed per data name: name -> {dst_mem: t}
        self.inflight: Dict[str, Dict[int, float]] = {}
        self.waiting: Dict[tuple, List[int]] = {}  # (name, mem) -> worker rids
        self.preds = [len(graph.pred[t.tid]) for t in graph.tasks]
        self.succ = [graph.succ[t.tid] for t in graph.tasks]
        self.done = [False] * len(graph)
        self.n_done = 0
        self.n_tasks = len(graph)
        self.predictors: Dict[str, ClassPredictor] = {}
        self.rid_static: List[List[float]] = []
        self.noise_mult: Optional[List[float]] = None
        self.finish = 0.0
        self.intervals: List[ScheduledInterval] = []
        self.submit_at = 0.0
        self.data_version: Dict[str, int] = {}  # bumped per write (cancel_stale)
        self.readers_left: List[int] = []  # per-did pending readers (bounded)
        # the tenant's weight for the priority / weighted-fair policies
        self.priority = 1.0
        # each task's execution attempt, bumped when a kill-mode detach
        # aborts it: the "done" event of the aborted run is then stale
        self.attempt: List[int] = [0] * len(graph)
        # serving mode: the working set admission control weighs, and the
        # arrival and admission flags (set only by Engine._arrive)
        self.ws_bytes = int(self.arrays.data_sizes.sum())
        self.arrived = False
        self.admitted = False
        self.rejected = False
        self.admit_at = 0.0


class Engine:
    """The event loop: events + queues + transfers.

    Strategies see the surface ``push``, ``load_ts``, ``now``,
    ``predictor``, ``residency``, ``arrays``, ``graph``, ``machine``,
    ``transfer_model``, ``model`` and ``memory``; during an activation
    these views point at the graph whose tasks became ready.
    """

    def __init__(
        self,
        machine: MachineModel,
        strategy,
        seed: int = 0,
        noise: float = 0.03,
        transfer_model: Optional[TransferModel] = None,
        audit: bool = False,
        mem_capacity: int = 0,
        eviction: str = "lru",
        churn: float = 0.0,
        fault_mode: str = "drain",
        fault_trace: Optional[str] = None,
        notice_s: float = 0.0,
        link_flake: float = 0.0,
        retry_max: int = 3,
        backoff_s: float = 1e-4,
        cancel_stale: bool = False,
        rescore: str = "off",
        admission: str = "none",
        admit_defer_s: float = 0.005,
        device="cuda",
        min_wide: int = 1,
    ) -> None:
        self.machine = machine
        self.strategy = strategy
        self._steal_on = strategy.allow_steal
        self._lifo = strategy.owner_lifo
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.model = HistoryPerfModel()
        self.transfer_model = transfer_model or TransferModel(
            bandwidth=machine.link.bandwidth, latency=machine.link.latency
        )

        self.now = 0.0
        self.events = EventQueue()
        self.workers = [Worker(r.rid) for r in machine.resources]
        # shared predicted-completion time-stamps (paper §2.3)
        self.load_ts = [0.0] * len(self.workers)
        # per-rid memory space / residency bit
        self._mem_of = [r.mem for r in machine.resources]
        self._bit_of = [1 << (r.mem + 1) for r in machine.resources]

        self.metrics = Metrics(machine)
        self.transfers = TransferEngine(machine, self.events, self.metrics)

        # capacity-bounded device memories (opt-in): an unbounded manager is
        # inert, and the transfers see it only when bounded
        self.memory = MemoryManager(machine, mem_capacity, eviction)
        self.memory.transfers = self.transfers
        self._bounded = self.memory.bounded
        if self._bounded:
            self.transfers.memory = self.memory
        self._cancel_stale = bool(cancel_stale)
        self.transfers.cancel_stale = self._cancel_stale

        # resource dynamics: the manager is always there, inert until a
        # fault source registers; the hot paths check _faults_on first
        self.faults = FaultManager(machine, mode=fault_mode)
        self.transfers.faults = self.faults
        self._faults_on = False
        self._notice_s = float(notice_s)
        if churn:
            self.faults.enable_churn(churn, seed=seed, mode=fault_mode, notice_s=self._notice_s)
            self._faults_on = True
        if fault_trace:
            self.replay_trace(fault_trace)
        # flaky links: a run with link_flake 0 never touches their stream
        self._flake_on = float(link_flake) > 0.0
        if self._flake_on:
            self.transfers.enable_flake(float(link_flake), int(retry_max), float(backoff_s), seed)

        # opt-in structured audit log (repro_torch.verify), logged with the
        # reference's settings for this engine: the capacity and eviction
        # policy, stale cancellation, the fault mode
        self.audit: Optional[AuditLog] = None
        if audit:
            self.audit = AuditLog(engine="exact")
            self.audit.log_machine(
                machine, host_mem=HOST_MEM,
                capacity=self.memory.capacity if self._bounded else 0, eviction=eviction,
                cancel_stale=self._cancel_stale, fault_mode=fault_mode, seed=seed, noise=noise,
            )
        self.transfers.audit = self.audit

        # serving mode: the shared ready pool (repro_torch.runtime.rescore)
        # and admission control; rescore="off" leaves the classic loop
        if rescore not in RESCORE_MODES:
            raise ValueError(f"rescore mode must be one of {RESCORE_MODES}, got {rescore!r}")
        if admission not in ADMISSION_MODES:
            raise ValueError(f"admission mode must be one of {ADMISSION_MODES}, got {admission!r}")
        self._serving: Optional[ServingScheduler] = None
        if rescore != "off":
            if strategy.allow_steal:
                raise ValueError(
                    f"serving mode (rescore={rescore!r}) places from the shared ready pool; "
                    f"work-stealing strategies ({strategy.name!r}) are not supported there"
                )
            self._serving = ServingScheduler(rescore, device=device, min_wide=min_wide)
        self._admission = admission
        if admission != "none" and self._serving is None:
            raise ValueError(
                f"admission={admission!r} requires serving mode (rescore='full' or "
                "'incremental'); the classic loop activates every submitted graph "
                "unconditionally"
            )
        if not (float(admit_defer_s) > 0.0):
            raise ValueError(f"admit_defer_s must be > 0, got {admit_defer_s!r}")
        self._admit_defer_s = float(admit_defer_s)
        # admission accounting: the working sets of admitted, unfinished
        # graphs against the device memories' total capacity
        self._active_ws = 0
        n_dev = len({r.mem for r in machine.resources if r.mem != HOST_MEM})
        self._mem_total = self.memory.capacity * n_dev
        # the strategy's tenant teardown hook, if it has one (wfq)
        self._retire = getattr(strategy, "retire_tenant", None)

        self._ctxs: List[GraphContext] = []
        self._ctx_of: Dict[int, GraphContext] = {}  # id(task) -> context
        self._cur: Optional[GraphContext] = None
        self._pending: List[GraphContext] = []  # roots placed when the run starts
        self._running = False
        # strategy-facing views of the current activation's graph
        self.graph: Optional[TaskGraph] = None
        self.arrays: Optional[GraphArrays] = None
        self.residency: Optional[Residency] = None

    # ------------------------------------------------------------------
    def submit(self, graph: TaskGraph, at: Optional[float] = None,
               priority: float = 1.0) -> GraphContext:
        """Add a task graph to the run. Before :meth:`run` its roots are
        placed when the run starts; with ``at`` (a simulated time after
        now) the arrival is a ``"submit"`` event at that time, and during
        the run the graph arrives at once. ``priority`` (> 0) weights the
        tenant for the ``priority`` and ``wfq`` policies; the other
        strategies ignore it. Returns the graph's :class:`GraphContext`."""
        if not (float(priority) > 0.0):
            raise ValueError(f"priority must be > 0, got {priority!r}")
        if graph.tasks and id(graph.tasks[0]) in self._ctx_of:
            raise ValueError(
                "this TaskGraph object is already submitted to the engine; "
                "build a fresh graph per submission"
            )
        ctx = GraphContext(len(self._ctxs), graph)
        # One multiplicative noise factor per task, drawn as a single
        # batched normal at submit, in tid order.
        if self.noise > 0 and len(graph) > 0:
            ctx.noise_mult = np.exp(
                self.rng.normal(0.0, self.noise, size=len(graph))
            ).tolist()
        ctx.priority = float(priority)
        ctx.rid_static = [
            self._predictor(ctx, r.cls).static_list
            for r in self.machine.resources
        ]
        self.memory.attach_ctx(ctx)
        if self._serving is not None:
            self._serving.watch_ctx(ctx)
        for t in graph.tasks:
            self._ctx_of[id(t)] = ctx
        self._ctxs.append(ctx)
        if self._cur is None:
            self._set_ctx(ctx)
        if at is not None and at > self.now:
            ctx.submit_at = at
            self.events.post(at, "submit", ctx)
        elif self._running:
            ctx.submit_at = self.now
            if self._serving is not None:
                self._arrive(ctx)
            else:
                self._activate_roots(ctx)
                if self._steal_on:
                    self._steal_round()
        else:
            ctx.submit_at = max(0.0, at if at is not None else 0.0)
            self._pending.append(ctx)
        if self.audit is not None:
            self.audit.log_graph(ctx.gid, ctx.submit_at, graph)
        return ctx

    def _set_ctx(self, ctx: GraphContext) -> None:
        self._cur = ctx
        self.graph = ctx.graph
        self.arrays = ctx.arrays
        self.residency = ctx.residency

    def _predictor(self, ctx: GraphContext, cls: ResourceClass) -> ClassPredictor:
        p = ctx.predictors.get(cls.name)
        if p is None:
            p = ctx.predictors[cls.name] = ClassPredictor(
                self.model, cls, ctx.arrays
            )
        return p

    def predictor(self, cls: ResourceClass) -> ClassPredictor:
        """Cached vectorized prediction for ``cls`` (of the current
        activation's graph)."""
        return self._predictor(self._cur, cls)

    # ------------------------------------------------------------------
    # fault injection (repro_torch.runtime.faults)
    def inject(self, event: str, rid: int, at: Optional[float] = None,
               mode: Optional[str] = None, notice_s: Optional[float] = None) -> None:
        """Schedule a ``"detach"`` or ``"attach"`` of resource ``rid``.

        ``at`` is simulated time (default now; a past time clamps to now).
        ``mode`` is a detach's recovery mode (``"drain"`` or ``"kill"``;
        default the engine's ``fault_mode``). ``notice_s`` (detach only;
        default the engine's) announces the death that long before: a
        notice fires at ``max(now, at - notice_s)``. The fault fires as an
        event of the run loop."""
        if event not in FAULT_EVENTS:
            raise ValueError(f"fault event must be one of {FAULT_EVENTS}, got {event!r}")
        if mode is not None and mode not in FAULT_MODES:
            raise ValueError(f"fault mode must be one of {FAULT_MODES}, got {mode!r}")
        if notice_s is not None:
            if event != "detach":
                raise ValueError(
                    f"notice_s only applies to detach events, got event={event!r}"
                )
            if not (float(notice_s) >= 0.0):
                raise ValueError(f"notice_s must be >= 0, got {notice_s!r}")
        self.faults._check_rid(rid)
        at = self.now if at is None else max(float(at), self.now)
        self.faults.active = True
        self._faults_on = True
        if event == "detach":
            ns = float(notice_s) if notice_s is not None else self._notice_s
            if ns > 0.0:
                t_n = max(self.now, at - ns)
                if t_n < at:
                    # the mode slot carries (mode, the scheduled death)
                    self.events.post(t_n, "fault", ("notice", int(rid), (mode, at)))
        self.events.post(at, "fault", (event, int(rid), mode))

    def replay_trace(self, trace) -> None:
        """Inject every event of a JSONL preemption trace: a path for
        :func:`repro_torch.runtime.traces.load_trace`, or an iterable of
        :class:`~repro_torch.runtime.traces.FaultEvent`."""
        events = load_trace(trace) if isinstance(trace, str) else trace
        for ev in events:
            self.inject(ev.event, ev.rid, at=ev.t, mode=ev.mode, notice_s=ev.notice_s)

    # ------------------------------------------------------------------
    def push(self, task: Task, rid: int) -> None:
        """Push ``task`` onto worker ``rid``'s queue and prefetch its inputs
        (work aimed at a dead worker goes to the next alive one)."""
        if self._faults_on and not self.faults.alive[rid]:
            rid = self.faults.redirect(rid)
        w = self.workers[rid]
        w.queue.append(task)
        ctx = self._ctx_of[id(task)]
        self.transfers.prefetch(
            ctx, task, self._mem_of[rid], self._bit_of[rid], self.now
        )
        self._try_start(w)

    def _steal(self, thief: Worker) -> bool:
        victims = eligible_victims(self.workers, thief.rid)
        if not victims:
            return False
        v = victims[int(self.rng.integers(len(victims)))]
        task = v.queue.popleft()  # thief takes the oldest task
        self.metrics.n_steals += 1
        thief.queue.append(task)
        ctx = self._ctx_of[id(task)]
        self.transfers.prefetch(
            ctx, task, self._mem_of[thief.rid], self._bit_of[thief.rid], self.now
        )
        return True

    def _steal_round(self) -> None:
        # callers guard on self._steal_on (strategy.allow_steal)
        progress = True
        faults_on = self._faults_on
        while progress:
            progress = False
            for w in self.workers:
                if w.running is None and not w.queue:
                    if faults_on and (not self.faults.alive[w.rid]
                                      or w.rid in self.faults.noticed):
                        continue  # dead and condemned workers do not steal
                    if self._steal(w):
                        self._try_start(w)
                        progress = True

    def _unpin_worker(self, w: Worker) -> None:
        if w.pins is not None:
            mem, dids, ctx = w.pins
            unpin = self.memory.unpin
            for did in dids:
                unpin(ctx, did, mem)
            w.pins = None

    def _try_start(self, w: Worker) -> None:
        if w.running is not None or not w.queue:
            return
        rid = w.rid
        if self._faults_on and (not self.faults.alive[rid] or rid in self.faults.noticed):
            # nothing starts on a detached worker, nor on a noticed one
            # inside its window: its queue is re-activated at the death
            return
        task = w.queue[-1] if self._lifo else w.queue[0]
        ctx = self._ctx_of[id(task)]
        # make sure inputs are (going to be) resident
        mem = self._mem_of[rid]
        bit = self._bit_of[rid]
        mask_list = ctx.residency.mask_list
        inflight = ctx.inflight
        waiting = ctx.waiting
        request = self.transfers.request
        now = self.now
        bounded = self._bounded
        reads = ctx.arrays.task_reads[task.tid]
        if bounded:
            # re-pin this head's resident inputs (dropping the pins of a
            # previous head evaluation)
            self._unpin_worker(w)
            pinned: List[int] = []
            protect = frozenset(d for d, _, _ in reads)
        missing = 0
        for did, name, size in reads:
            if not mask_list[did] & bit:
                fl = inflight.get(name)
                if fl is None or mem not in fl:
                    request(ctx, name, size, mem, now, protect if bounded else None)
                waiting.setdefault((name, mem), []).append(rid)
                missing += 1
            elif bounded and mem != HOST_MEM:
                self.memory.pin(ctx, did, mem)
                self.memory.touch(ctx, did, mem)
                pinned.append(did)
        if bounded and (pinned or missing):
            w.pins = (mem, pinned, ctx)
        if missing:
            w.blocked_on = missing
            return
        if self._lifo:
            w.queue.pop()
        else:
            w.queue.popleft()
        w.blocked_on = 0
        tid = task.tid
        # ground-truth duration: per-rid static flops/rate times the
        # task's seeded noise factor
        dur = ctx.rid_static[rid][tid]
        if ctx.noise_mult is not None:
            dur *= ctx.noise_mult[tid]
        w.running = task
        w.run_start = now
        self.events.post(now + dur, "done", (rid, ctx, tid, dur, ctx.attempt[tid]))

    def _complete(self, rid: int, ctx: GraphContext, tid: int, dur: float) -> None:
        w = self.workers[rid]
        res = self.machine.resources[rid]
        task = ctx.graph.tasks[tid]
        w.running = None
        ctx.done[tid] = True
        ctx.n_done += 1
        metrics = self.metrics
        metrics.busy[rid] += dur
        iv = ScheduledInterval(tid, rid, w.run_start, self.now)
        metrics.intervals.append(iv)
        ctx.intervals.append(iv)
        self.model.observe(task, res.cls, dur)
        bit = self._bit_of[rid]
        bounded = self._bounded
        # a drained worker finishing after its detach: its memory is gone,
        # so the outputs are written back to host on the memory's link
        dead_mem = None
        if self._faults_on and not self.faults.alive[rid]:
            m = self._mem_of[rid]
            if m != HOST_MEM and m in self.faults.dead_mems:
                dead_mem = m
        if bounded:
            self._unpin_worker(w)
            mem = self._mem_of[rid]
            if mem != HOST_MEM and dead_mem is None:
                # make room for the outputs this completion materializes
                incoming = 0
                mask_list = ctx.residency.mask_list
                for did, _, size in ctx.arrays.task_writes[tid]:
                    if not mask_list[did] & bit:
                        incoming += size
                if incoming:
                    protect = frozenset(
                        d for d, _, _ in ctx.arrays.task_writes[tid]
                    ) | frozenset(d for d, _, _ in ctx.arrays.task_reads[tid])
                    self.memory.ensure_capacity(mem, incoming, self.now, ctx, protect)
        write_id = ctx.residency.write_id
        inflight_pop = ctx.inflight.pop
        cancel_stale = self._cancel_stale
        versions = ctx.data_version
        for did, name, size in ctx.arrays.task_writes[tid]:
            if dead_mem is not None:
                self.transfers.one_hop(size, self.transfers.mem_link.get(dead_mem), self.now,
                                       kind="evacuate")
                metrics.n_evacuations += 1
                metrics.evacuated_bytes += size
                write_id(did, name, 1)  # the sole valid copy lands on host
            else:
                write_id(did, name, bit)
            # invalidate any stale dedup entries for this data
            inflight_pop(name, None)
            if cancel_stale:
                versions[name] = versions.get(name, 0) + 1
        if self.audit is not None:
            # after the write loop: the eviction records ensure_capacity
            # emitted above come first, as the verifier replays them
            self.audit.log_exec(ctx.gid, tid, rid, self._mem_of[rid], w.run_start, self.now,
                                wrote_host=dead_mem is not None)
        if bounded:
            self.memory.note_task_done(ctx, tid)
        # load time-stamp correction (§2.3: runtime corrects predictions)
        if not w.queue:
            self.load_ts[rid] = self.now

        newly_ready: List[Task] = []
        preds = ctx.preds
        tasks = ctx.graph.tasks
        for s in ctx.succ[tid]:
            preds[s] -= 1
            if preds[s] == 0:
                newly_ready.append(tasks[s])
        if ctx.n_done == ctx.n_tasks:
            ctx.finish = self.now
            if self._serving is not None:
                self._graph_finished(ctx)
        if newly_ready:
            # the *activate* operation — where scheduling decisions happen
            self._place_ready(ctx, newly_ready, rid)
        self._try_start(w)
        if self._steal_on:
            self._steal_round()

    def _place_ready(self, ctx: GraphContext, ready: List[Task], src: Optional[int]) -> None:
        """Route newly-ready tasks of ``ctx``: to the strategy's ``place``
        (classic loop) or into the serving pool. The one seam every
        activation flows through, re-activations after a detach
        included."""
        if self._serving is not None:
            self._serving.add_ready(self, ctx, ready)
        else:
            self._set_ctx(ctx)
            self.strategy.place(self, ready, src)

    def _activate_roots(self, ctx: GraphContext) -> None:
        roots = ctx.graph.roots()
        if roots:
            self._place_ready(ctx, roots, None)

    # ------------------------------------------------------------------
    # serving mode: arrivals, admission control, tenant teardown
    def _graph_finished(self, ctx: GraphContext) -> None:
        if self._admission != "none" and ctx.admitted:
            self._active_ws -= ctx.ws_bytes
        if self._retire is not None:
            self._retire(ctx)

    def _arrive(self, ctx: GraphContext) -> None:
        """A tenant graph arrives at ``self.now`` (serving mode): log the
        arrival once, run admission control, then activate its roots."""
        audit = self.audit
        if not ctx.arrived:
            ctx.arrived = True
            self.metrics.n_arrivals += 1
            if audit is not None:
                audit.log_arrival(ctx.gid, ctx.submit_at)
        if self._admission != "none" and self._bounded:
            ws = ctx.ws_bytes
            total = self._mem_total
            if ws > total:
                # it can never fit: rejected outright (defer would retry
                # forever)
                ctx.rejected = True
                self.metrics.n_rejected += 1
                if audit is not None:
                    audit.log_reject(ctx.gid, self.now, "too_large")
                return
            if self._active_ws + ws > total:
                if self._admission == "defer":
                    self.metrics.n_deferred += 1
                    self.events.post(self.now + self._admit_defer_s, "submit", ctx)
                else:
                    ctx.rejected = True
                    self.metrics.n_rejected += 1
                    if audit is not None:
                        audit.log_reject(ctx.gid, self.now, "pressure")
                return
            self._active_ws += ws
        ctx.admitted = True
        ctx.admit_at = self.now
        self.metrics.n_admitted += 1
        if audit is not None:
            audit.log_admit(ctx.gid, self.now)
        self._activate_roots(ctx)

    # ------------------------------------------------------------------
    def _land(self, t: float, ctx: GraphContext, name: str, mem: int, ver: int,
              epoch: int) -> None:
        """A copy of ``name`` lands at memory ``mem`` (an ``"xfer"``
        event): dropped if its memory detached while it was in flight
        (``"dead"``) or, under ``cancel_stale``, if its data was
        overwritten (``"stale"``); else a valid copy. Its blocked readers
        then re-evaluate."""
        inflight = ctx.inflight
        flights = inflight.get(name)
        if flights is not None:
            flights.pop(mem, None)
            if not flights:
                del inflight[name]
        memory = self.memory
        faults = self.faults
        audit = self.audit
        did = None
        if self._bounded and mem != HOST_MEM:
            memory.release(ctx, name, mem)
            did = ctx.arrays.name_to_id.get(name)
        if self._faults_on and mem != HOST_MEM and (
                mem in faults.dead_mems or epoch != faults.mem_epoch.get(mem, 0)):
            # the destination detached while this copy was in flight: the
            # copy died with it (its waiters were scrubbed at the detach)
            if audit is not None:
                audit.log_landing(ctx.gid, name, mem, t, False, "dead")
        elif self._cancel_stale and ver != ctx.data_version.get(name, 0):
            # the data was overwritten while this copy was in flight: the
            # landing is stale (the blocked readers re-request the new one)
            if audit is not None:
                audit.log_landing(ctx.gid, name, mem, t, False, "stale")
        else:
            if did is not None and not (ctx.residency.mask_list[did] & (1 << (mem + 1))):
                memory.ensure_capacity(mem, ctx.residency._sizes[did], t, ctx, (did,))
            ctx.residency.add_copy(name, mem)
            if audit is not None:
                audit.log_landing(ctx.gid, name, mem, t, True, "ok")
        waiters = ctx.waiting.pop((name, mem), None)
        if waiters:
            workers = self.workers
            for rid in waiters:
                w = workers[rid]
                if w.blocked_on > 0:
                    w.blocked_on -= 1
                    if (did is not None and w.pins is not None and w.pins[0] == mem
                            and w.pins[2] is ctx and w.blocked_on > 0):
                        # keep the landed input of a still-blocked head
                        # pinned until its next evaluation (only while the
                        # head is this graph's task)
                        memory.pin(ctx, did, mem)
                        w.pins[1].append(did)
                    if w.blocked_on == 0:
                        self._try_start(w)

    def _run_loop(self) -> None:
        self._running = True
        self.strategy.init(self)
        self.faults.schedule_churn(self)
        pending, self._pending = self._pending, []
        for ctx in pending:
            self._activate_roots(ctx)
        steal_on = self._steal_on
        if steal_on:
            self._steal_round()
        events = self.events.heap
        heappop = heapq.heappop
        land = self._land
        faults = self.faults
        n_events = 0
        while events:
            t, _, kind, payload = heappop(events)
            self.now = t
            n_events += 1
            if kind == "xfer":
                land(t, *payload)
                if steal_on:
                    self._steal_round()
            elif kind == "done":
                rid, ctx, tid, dur, att = payload
                # a stale attempt is an execution aborted by a kill-mode
                # detach: the task was re-activated elsewhere
                if att == ctx.attempt[tid]:
                    self._complete(rid, ctx, tid, dur)
            elif kind == "fault":
                action, rid, mode = payload
                faults.handle(self, action, rid, mode)
            else:  # "submit": a streamed graph arrives
                self._activate_roots(payload)
                if steal_on:
                    self._steal_round()
        self.metrics.n_events = n_events
        if self.audit is not None:
            self.audit.finalize(self)
        self._check_complete()

    def _run_loop_serving(self, max_events: Optional[int] = None) -> bool:
        """The serving loop: the events of one simulated instant are
        drained together, then one placement round runs over the pool.
        Returns True when ``max_events`` cut the run short (such a run is
        neither finalized nor checked for completeness)."""
        serving = self._serving
        self._running = True
        self.strategy.init(self)
        self.faults.schedule_churn(self)
        pending, self._pending = self._pending, []
        for ctx in pending:
            self._arrive(ctx)
        serving.round(self)
        events = self.events.heap
        heappop = heapq.heappop
        land = self._land
        faults = self.faults
        n_events = 0
        capped = False
        while events and not capped:
            t = events[0][0]
            self.now = t
            while events and events[0][0] == t:
                _, _, kind, payload = heappop(events)
                n_events += 1
                if kind == "xfer":
                    land(t, *payload)
                elif kind == "done":
                    rid, ctx, tid, dur, att = payload
                    if att == ctx.attempt[tid]:
                        self._complete(rid, ctx, tid, dur)
                elif kind == "fault":
                    action, rid, mode = payload
                    faults.handle(self, action, rid, mode)
                    # liveness and memory epochs moved: every cached row
                    # is suspect
                    serving.epoch += 1
                else:  # "submit": a streamed tenant graph arrives
                    self._arrive(payload)
                if max_events is not None and n_events >= max_events:
                    capped = True
                    break
            serving.round(self)
        self.metrics.n_events = n_events
        if capped:
            return True
        if self.audit is not None:
            self.audit.finalize(self)
        self._check_complete()
        return False

    def _check_complete(self) -> None:
        for ctx in self._ctxs:
            if ctx.rejected:
                continue  # admission control turned this tenant away
            if ctx.n_done != ctx.n_tasks:
                missing = [t.tid for t in ctx.graph.tasks if not ctx.done[t.tid]]
                raise RuntimeError(
                    f"simulation stalled: graph {ctx.gid} has "
                    f"{len(missing)} tasks unfinished, e.g. {missing[:5]}"
                    + (" (capacity-bounded run: check mem_capacity)" if self._bounded else "")
                )

    def _graph_result(self, ctx: GraphContext) -> SimResult:
        busy: Dict[int, float] = {r.rid: 0.0 for r in self.machine.resources}
        for iv in ctx.intervals:
            busy[iv.rid] += iv.end - iv.start
        return SimResult(
            makespan=(ctx.finish - ctx.submit_at) if not ctx.rejected else 0.0,
            total_bytes=self.metrics.total_bytes,
            n_transfers=self.metrics.n_transfers,
            busy=busy,
            intervals=ctx.intervals,
            strategy=self.strategy.name,
            total_flops=ctx.graph.total_flops(),
            n_events=self.metrics.n_events,
            n_steals=self.metrics.n_steals,
            faults=self.fault_summary(),
            submit_at=ctx.submit_at,
            admit_at=ctx.admit_at if self._serving is not None else ctx.submit_at,
            admitted=not ctx.rejected,
        )

    def run(self, max_events: Optional[int] = None) -> List[SimResult]:
        """Run every submitted graph to completion; one result per graph
        (submit order), its makespan counted from its submit time.
        Transfer counters are machine-global. ``max_events`` (serving mode
        only) stops the run after that many events and returns ``[]``:
        throughput probes measure a fixed amount of work."""
        if self._serving is not None:
            if self._run_loop_serving(max_events):
                return []
        else:
            if max_events is not None:
                raise ValueError("max_events requires serving mode "
                                 "(rescore='full' or 'incremental')")
            self._run_loop()
        return [self._graph_result(ctx) for ctx in self._ctxs]

    def fault_summary(self) -> Optional[Dict[str, float]]:
        """The fault counters of a run with a fault source or flaky links
        (``SimResult.faults``); None otherwise."""
        if self._faults_on or self._flake_on:
            return self.metrics.fault_summary()
        return None
