"""Structured schedule audit log shared by both engines.

The exact engine (:mod:`repro_torch.runtime.engine`, with ``audit=True``)
and the batched surrogate (:func:`repro_torch.core.episode.episode_audit_logs`
over a ``run_episodes(..., emit_schedule=True)`` output) both emit this
schema. The log is *observational*: it records what an engine claims
happened (who ran where and when, which bytes moved, which copies landed
or were dropped, which resources died) plus enough static context
(machine shape, per-graph task access lists) for the verifier in
:mod:`repro_torch.verify.schedule` to re-derive legality from first
principles.

Deliberately stdlib-only — no numpy, no torch, no imports from
``repro_torch.core`` or ``repro_torch.runtime`` — so the verifier
consuming it shares no code with the engines it checks.

The JSONL schema (:meth:`AuditLog.to_jsonl`) is that of ``repro.verify``
field for field, so a log written by either package reads in the other.
The records for arrivals, admits and rejects have no producer in the
port's engine yet (it has no serving mode); they are kept so that logs
of such runs read and verify here.

Every record carries a monotonically increasing ``seq`` assigned in log
order.  Engines process same-timestamp events in a deterministic order;
``seq`` preserves that order so the verifier can replay state changes at
equal timestamps without re-implementing engine tie-breaking.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Tuple

SCHEMA_VERSION = 1


@dataclass
class ExecRecord:
    """One task execution (attempt that completed)."""

    seq: int
    gid: int
    tid: int
    rid: int
    mem: int
    start: float
    end: float
    # kill/drain salvage: outputs were written back to host because the
    # executing resource's memory died before completion
    wrote_host: bool = False


@dataclass
class HopRecord:
    """One accounted link occupation (the only place bytes count).

    ``kind``: "copy" (demand transfer hop), "writeback" (dirty
    eviction), "evacuate" (fault salvage), "proactive" (notice-window
    replication), "retry" (flaky hop re-attempt), "resource"
    (post-timeout re-source from another live copy or host).
    """

    seq: int
    kind: str
    nbytes: int
    group: Optional[int]
    t: float
    done: float


@dataclass
class LandRecord:
    """A transfer arrival event and the engine's landing decision.

    ``reason``: "ok" (copy became resident), "dead" (target memory died
    or its epoch advanced mid-flight), "stale" (cancel-stale mode
    dropped an outdated version).  ``t_req`` is the time the transfer
    was requested, matched from the request site.
    """

    seq: int
    gid: int
    name: str
    mem: int
    t: float
    landed: bool
    reason: str
    t_req: Optional[float] = None


@dataclass
class EvictRecord:
    """A capacity eviction; ``dirty`` means a write-back hop preceded."""

    seq: int
    gid: int
    name: str
    mem: int
    t: float
    dirty: bool


@dataclass
class FaultRecord:
    """A detach/attach event on a resource."""

    seq: int
    t: float
    event: str
    rid: int
    mode: Optional[str]


@dataclass
class NoticeRecord:
    """A preemption notice: ``rid`` will detach at ``death_at``.

    Opens the grace window ``(t, death_at)`` inside which the engine
    must start no new execution on ``rid`` (the NOTICE_GRACE invariant).
    """

    seq: int
    t: float
    rid: int
    mode: Optional[str]
    death_at: float


@dataclass
class RetryRecord:
    """A flaky demand hop failed and was retried with backoff.

    ``attempt`` is 1-based; ``delay_s`` the backoff injected before the
    re-attempt; ``nbytes`` must match a same-sized ``retry`` hop (the
    RETRY_BYTES invariant: every retried byte is re-charged on the wire).
    """

    seq: int
    gid: int
    name: str
    mem: int
    t: float
    attempt: int
    delay_s: float
    nbytes: int


@dataclass
class TimeoutRecord:
    """A transfer exhausted its retry budget and was re-sourced.

    ``attempts`` counts the failed tries; the transfer must still land —
    a matching ``resource`` hop and a later landing record close it (the
    TRANSFER_COMPLETES invariant).
    """

    seq: int
    gid: int
    name: str
    mem: int
    t: float
    attempts: int
    nbytes: int


@dataclass
class ArrivalRecord:
    """A tenant graph reached the machine (serving mode): ``t`` is its
    submit time — no execution of the graph may start before it (the
    ARRIVAL invariant)."""

    seq: int
    gid: int
    t: float


@dataclass
class AdmitRecord:
    """Admission control let the tenant in at ``t``; executions must not
    start before the admit time either (deferred tenants wait)."""

    seq: int
    gid: int
    t: float


@dataclass
class RejectRecord:
    """Admission control turned the tenant away: the graph must show no
    executions at all.  ``reason``: "too_large" (working set exceeds the
    machine's aggregate capacity outright) or "pressure" (no room amid
    currently-admitted tenants)."""

    seq: int
    gid: int
    t: float
    reason: str


_RECORD_TYPES = {
    "exec": ExecRecord,
    "hop": HopRecord,
    "land": LandRecord,
    "evict": EvictRecord,
    "fault": FaultRecord,
    "notice": NoticeRecord,
    "retry": RetryRecord,
    "timeout": TimeoutRecord,
    "arrival": ArrivalRecord,
    "admit": AdmitRecord,
    "reject": RejectRecord,
}


def graph_accesses(graph: Any) -> List[List[Tuple[str, int, str]]]:
    """Extract the static per-task access lists from a TaskGraph.

    Returns one ``(data_name, size_bytes, mode)`` list per task, with
    ``mode`` in {"r", "w", "rw"} — everything the verifier needs to
    re-derive dependency edges and data sizes without importing the DAG
    machinery.
    """
    return [
        [(a.data.name, int(a.data.size_bytes), a.mode.value) for a in t.accesses]
        for t in graph.tasks
    ]


class AuditLog:
    """Accumulates records from one engine run; see module docstring."""

    def __init__(self, engine: str = "exact"):
        self.engine = engine
        self.machine: Dict[str, Any] = {}
        self.graphs: Dict[int, Dict[str, Any]] = {}
        self.execs: List[ExecRecord] = []
        self.hops: List[HopRecord] = []
        self.landings: List[LandRecord] = []
        self.evictions: List[EvictRecord] = []
        self.faults: List[FaultRecord] = []
        self.notices: List[NoticeRecord] = []
        self.retries: List[RetryRecord] = []
        self.timeouts: List[TimeoutRecord] = []
        self.arrivals: List[ArrivalRecord] = []
        self.admits: List[AdmitRecord] = []
        self.rejects: List[RejectRecord] = []
        self.result: Dict[str, Any] = {}
        self._seq = 0
        # (gid, name, dst_mem, done_t) -> request time, popped on landing
        self._pending_req: Dict[Tuple[int, str, int, float], float] = {}

    # ------------------------------------------------------------------
    # producer API (called from the engines)
    # ------------------------------------------------------------------
    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def log_machine(self, machine: Any, **info: Any) -> None:
        resources = [
            {
                "rid": int(r.rid),
                "mem": int(r.mem),
                "is_accelerator": bool(r.is_accelerator),
                "link": getattr(r, "link", None),
            }
            for r in machine.resources
        ]
        self.machine = dict(info, resources=resources)

    def log_graph(self, gid: int, submit_at: float, graph: Any) -> None:
        self.graphs[int(gid)] = {
            "submit_at": float(submit_at),
            "tasks": graph_accesses(graph),
        }

    def log_exec(
        self,
        gid: int,
        tid: int,
        rid: int,
        mem: int,
        start: float,
        end: float,
        wrote_host: bool = False,
    ) -> None:
        self.execs.append(
            ExecRecord(
                self._next_seq(),
                int(gid),
                int(tid),
                int(rid),
                int(mem),
                float(start),
                float(end),
                bool(wrote_host),
            )
        )

    def log_hop(
        self, kind: str, nbytes: int, group: Optional[int], t: float, done: float
    ) -> None:
        self.hops.append(
            HopRecord(
                self._next_seq(),
                kind,
                int(nbytes),
                None if group is None else int(group),
                float(t),
                float(done),
            )
        )

    def note_request(
        self, gid: int, name: str, dst_mem: int, done: float, t_req: float
    ) -> None:
        self._pending_req[(int(gid), name, int(dst_mem), float(done))] = float(t_req)

    def log_landing(
        self, gid: int, name: str, mem: int, t: float, landed: bool, reason: str
    ) -> None:
        t_req = self._pending_req.pop((int(gid), name, int(mem), float(t)), None)
        self.landings.append(
            LandRecord(
                self._next_seq(),
                int(gid),
                name,
                int(mem),
                float(t),
                bool(landed),
                reason,
                t_req,
            )
        )

    def log_evict(self, gid: int, name: str, mem: int, t: float, dirty: bool) -> None:
        self.evictions.append(
            EvictRecord(self._next_seq(), int(gid), name, int(mem), float(t), bool(dirty))
        )

    def log_fault(self, t: float, event: str, rid: int, mode: Optional[str]) -> None:
        self.faults.append(FaultRecord(self._next_seq(), float(t), event, int(rid), mode))

    def log_notice(
        self, t: float, rid: int, mode: Optional[str], death_at: float
    ) -> None:
        self.notices.append(
            NoticeRecord(
                self._next_seq(), float(t), int(rid), mode, float(death_at)
            )
        )

    def log_retry(
        self,
        gid: int,
        name: str,
        mem: int,
        t: float,
        attempt: int,
        delay_s: float,
        nbytes: int,
    ) -> None:
        self.retries.append(
            RetryRecord(
                self._next_seq(), int(gid), name, int(mem), float(t),
                int(attempt), float(delay_s), int(nbytes),
            )
        )

    def log_timeout(
        self, gid: int, name: str, mem: int, t: float, attempts: int, nbytes: int
    ) -> None:
        self.timeouts.append(
            TimeoutRecord(
                self._next_seq(), int(gid), name, int(mem), float(t),
                int(attempts), int(nbytes),
            )
        )

    def log_arrival(self, gid: int, t: float) -> None:
        self.arrivals.append(ArrivalRecord(self._next_seq(), int(gid), float(t)))

    def log_admit(self, gid: int, t: float) -> None:
        self.admits.append(AdmitRecord(self._next_seq(), int(gid), float(t)))

    def log_reject(self, gid: int, t: float, reason: str) -> None:
        self.rejects.append(
            RejectRecord(self._next_seq(), int(gid), float(t), reason)
        )

    def finalize(self, engine: Any) -> None:
        """Snapshot the engine's claimed result after the run loop ends."""
        per_graph: Dict[int, Dict[str, Any]] = {}
        for ctx in engine._ctxs:
            gid = int(ctx.gid)
            per_graph[gid] = {
                "submit_at": float(ctx.submit_at),
                "finish": float(ctx.finish),
                "n_done": int(ctx.n_done),
            }
            # serving-mode arrival accounting (surrogate contexts carry
            # no admission state — default to plain admitted-at-submit)
            if getattr(ctx, "rejected", False):
                per_graph[gid]["rejected"] = True
            if getattr(ctx, "admitted", False):
                per_graph[gid]["admit_at"] = float(ctx.admit_at)
            if gid in self.graphs:
                self.graphs[gid]["submit_at"] = float(ctx.submit_at)
        self.result = {
            "total_bytes": int(engine.metrics.total_bytes),
            "n_transfers": int(engine.metrics.n_transfers),
            "makespan": float(engine.now),
            "n_retries": int(engine.metrics.n_retries),
            "n_timeouts": int(engine.metrics.n_timeouts),
            "per_graph": per_graph,
        }

    # ------------------------------------------------------------------
    # JSONL round-trip
    # ------------------------------------------------------------------
    def to_jsonl(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            header = {
                "type": "header",
                "schema": SCHEMA_VERSION,
                "engine": self.engine,
                "machine": self.machine,
                "result": self.result,
            }
            fh.write(json.dumps(header) + "\n")
            for gid, info in sorted(self.graphs.items()):
                fh.write(
                    json.dumps({"type": "graph", "gid": gid, **info}) + "\n"
                )
            for tag, records in (
                ("exec", self.execs),
                ("hop", self.hops),
                ("land", self.landings),
                ("evict", self.evictions),
                ("fault", self.faults),
                ("notice", self.notices),
                ("retry", self.retries),
                ("timeout", self.timeouts),
                ("arrival", self.arrivals),
                ("admit", self.admits),
                ("reject", self.rejects),
            ):
                for rec in records:
                    fh.write(json.dumps({"type": tag, **asdict(rec)}) + "\n")

    @classmethod
    def from_jsonl(cls, path: str) -> "AuditLog":
        log = cls()
        with open(path, "r", encoding="utf-8") as fh:
            for lineno, line in enumerate(fh, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError as exc:
                    raise ValueError(f"{path}:{lineno}: invalid JSON: {exc}") from None
                kind = obj.pop("type", None)
                if kind == "header":
                    if obj.get("schema") != SCHEMA_VERSION:
                        raise ValueError(
                            f"{path}:{lineno}: unsupported audit schema "
                            f"{obj.get('schema')!r} (want {SCHEMA_VERSION})"
                        )
                    log.engine = obj.get("engine", "exact")
                    log.machine = obj.get("machine", {})
                    log.result = obj.get("result", {})
                elif kind == "graph":
                    gid = int(obj.pop("gid"))
                    obj["tasks"] = [
                        [(n, int(s), m) for n, s, m in task] for task in obj["tasks"]
                    ]
                    log.graphs[gid] = obj
                elif kind in _RECORD_TYPES:
                    rec_cls = _RECORD_TYPES[kind]
                    try:
                        rec = rec_cls(**obj)
                    except TypeError as exc:
                        raise ValueError(f"{path}:{lineno}: bad {kind} record: {exc}")
                    getattr(
                        log,
                        {
                            "exec": "execs",
                            "hop": "hops",
                            "land": "landings",
                            "evict": "evictions",
                            "fault": "faults",
                            "notice": "notices",
                            "retry": "retries",
                            "timeout": "timeouts",
                            "arrival": "arrivals",
                            "admit": "admits",
                            "reject": "rejects",
                        }[kind],
                    ).append(rec)
                    log._seq = max(log._seq, rec.seq)
                else:
                    raise ValueError(f"{path}:{lineno}: unknown record type {kind!r}")
        return log
