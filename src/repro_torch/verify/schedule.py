"""Independent schedule verifier.

Consumes an :class:`repro_torch.verify.audit.AuditLog` and re-checks, from
first principles, that the recorded schedule is legal.  Nothing here
imports or reuses engine code: dependency edges are re-derived from the
static task access lists via the Bernstein conditions, residency is
reconstructed by replaying landings/writes/evictions/fault salvage, and
every invariant below is checked against that reconstruction.

Invariants (exact engine):

- ``EXACTLY_ONCE``   every submitted task executed exactly once (kill
  mode may retry attempts, but only one completion may be recorded).
- ``PRECEDENCE``     no task starts before every predecessor (RAW, WAW
  and WAR edges) has completed.
- ``DATA_ARRIVAL``   every datum a task reads was resident in the
  executing resource's memory at task start.
- ``STALE_READ``     a read observed a copy whose version predates the
  latest completed write.  Warning by default: with cancel-stale off
  (the default) the engine deliberately lands in-flight copies of
  overwritten data — a documented modeling artifact.  An error when the
  log says cancel-stale was on.
- ``CAPACITY``       per-device-memory resident bytes never exceed the
  configured capacity.
- ``DEAD_LANDING``   no transfer recorded as landed in a dead memory.
- ``DEAD_WINDOW``    no execution starts strictly inside a detach→attach
  window of its resource (drain lets in-flight work finish; kill must
  requeue, so a start inside the window is always a bug).
- ``BYTES``          sum of logged hop bytes equals the engine's claimed
  ``total_bytes``, and the hop count equals ``n_transfers``.
- ``NOTICE_GRACE``   no execution starts strictly inside a preemption
  notice window — (notice, next detach/attach) of its resource.  A
  noticed worker may finish in-flight work but must accept no new work.
- ``RETRY_BYTES``    every retry record pairs with a ``retry`` hop and
  every timeout record with a ``resource`` hop, byte-for-byte and
  count-for-count (retried traffic is re-charged on the wire, never
  silently absorbed); claimed ``n_retries``/``n_timeouts`` match the
  record counts when the result reports them.
- ``TRANSFER_COMPLETES``  every retried or timed-out transfer is
  followed by a landing record for the same (graph, datum, memory) at
  or after the retry/timeout time — no transfer retries forever.
- ``MAKESPAN``       each graph's recorded finish time equals the max
  recorded execution end for that graph.
- ``ARRIVAL``        no execution of a graph's task starts before the
  graph's submit time (and, in serving mode, before its admit time); a
  graph admission control rejected must show no executions at all, and
  the claimed per-graph admission accounting (admit_at / rejected in
  the result) must agree with the arrival/admit/reject records.

The surrogate engine logs coarser records (no per-copy landings), so it
gets the subset that is meaningful there: EXACTLY_ONCE, PRECEDENCE,
RESOURCE_VALID, BYTES and MAKESPAN, with float32-scaled tolerances.
"""

from __future__ import annotations

import math
from bisect import bisect_right, insort
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .audit import AuditLog, ExecRecord


@dataclass
class Finding:
    code: str
    severity: str  # "error" | "warning"
    message: str

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"[{self.severity}] {self.code}: {self.message}"


def errors(findings: Sequence[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == "error"]


def derive_edges(tasks: Sequence[Sequence[Tuple[str, int, str]]]) -> List[List[int]]:
    """Re-derive per-task predecessor lists from access lists.

    Bernstein conditions on sequential task-creation order: a reader
    depends on the last writer (RAW); a writer depends on the last
    writer (WAW) and on every reader since that write (WAR).  This is an
    independent re-statement of the data-flow semantics, not a call into
    ``core.dag``.
    """
    last_writer: Dict[str, int] = {}
    readers: Dict[str, List[int]] = {}
    preds: List[List[int]] = []
    for tid, accesses in enumerate(tasks):
        dep: Set[int] = set()
        for name, _size, mode in accesses:
            r = "r" in mode
            w = "w" in mode
            if r or w:
                lw = last_writer.get(name)
                if lw is not None:
                    dep.add(lw)
            if w:
                dep.update(readers.get(name, ()))
        dep.discard(tid)
        preds.append(sorted(dep))
        for name, _size, mode in accesses:
            r = "r" in mode
            w = "w" in mode
            if w:
                last_writer[name] = tid
                readers[name] = []
            elif r:
                readers.setdefault(name, []).append(tid)
    return preds


def verify_audit(log: AuditLog) -> List[Finding]:
    """Run every applicable invariant; returns findings (may be empty)."""
    if log.engine == "surrogate":
        return _verify_surrogate(log)
    return _verify_exact(log)


# ----------------------------------------------------------------------
# helpers shared by both paths
# ----------------------------------------------------------------------
def _reads_writes(
    accesses: Sequence[Tuple[str, int, str]]
) -> Tuple[List[str], List[str]]:
    reads = [n for n, _s, m in accesses if "r" in m]
    writes = [n for n, _s, m in accesses if "w" in m]
    return reads, writes


def _exec_index(
    log: AuditLog, out: List[Finding]
) -> Dict[Tuple[int, int], ExecRecord]:
    """EXACTLY_ONCE check; returns the (gid, tid) -> record map."""
    seen: Dict[Tuple[int, int], int] = {}
    index: Dict[Tuple[int, int], ExecRecord] = {}
    # admission-rejected graphs legitimately never execute; the ARRIVAL
    # invariant separately errors if they *do* show executions
    rejected = {r.gid for r in log.rejects}
    for rec in log.execs:
        key = (rec.gid, rec.tid)
        seen[key] = seen.get(key, 0) + 1
        index.setdefault(key, rec)
        ginfo = log.graphs.get(rec.gid)
        if ginfo is None or not (0 <= rec.tid < len(ginfo["tasks"])):
            out.append(
                Finding(
                    "EXACTLY_ONCE",
                    "error",
                    f"execution recorded for unknown task g{rec.gid}/t{rec.tid}",
                )
            )
    for gid, ginfo in log.graphs.items():
        if gid in rejected:
            continue
        for tid in range(len(ginfo["tasks"])):
            n = seen.get((gid, tid), 0)
            if n != 1:
                out.append(
                    Finding(
                        "EXACTLY_ONCE",
                        "error",
                        f"task g{gid}/t{tid} executed {n} times (want exactly 1)",
                    )
                )
    return index


def _check_bytes(log: AuditLog, out: List[Finding], rel_tol: float = 0.0) -> None:
    claimed = log.result.get("total_bytes")
    if claimed is None:
        return
    logged = sum(h.nbytes for h in log.hops)
    if rel_tol:
        ok = math.isclose(logged, claimed, rel_tol=rel_tol, abs_tol=1.0)
    else:
        ok = logged == claimed
    if not ok:
        out.append(
            Finding(
                "BYTES",
                "error",
                f"logged hop bytes {logged} != claimed total_bytes {claimed}",
            )
        )
    n_claimed = log.result.get("n_transfers")
    if n_claimed is not None and len(log.hops) != n_claimed:
        out.append(
            Finding(
                "BYTES",
                "error",
                f"logged hop count {len(log.hops)} != claimed n_transfers {n_claimed}",
            )
        )


# ----------------------------------------------------------------------
# exact engine
# ----------------------------------------------------------------------
class _Intervals:
    """Residency intervals for one (gid, name, mem): versioned, queryable."""

    __slots__ = ("starts", "items")

    def __init__(self) -> None:
        self.starts: List[float] = []
        self.items: List[List[float]] = []  # [t0, t1, version], t1 = inf while open

    def open(self, t: float, version: int) -> None:
        if self.items and self.items[-1][1] == math.inf:
            # wholesale replacement (e.g. stale landing over a live copy)
            self.items[-1][1] = t
        insort(self.starts, t)
        self.items.append([t, math.inf, float(version)])
        self.items.sort(key=lambda iv: iv[0])

    def close(self, t: float) -> None:
        if self.items and self.items[-1][1] == math.inf:
            self.items[-1][1] = t

    def covering(self, t: float, eps: float) -> Optional[List[float]]:
        # closed-interval membership with tolerance; latest-opened wins
        for iv in reversed(self.items):
            if iv[0] - eps <= t <= iv[1] + eps:
                return iv
        return None


def _fault_windows(
    log: AuditLog, resources: Sequence[Dict[str, Any]], host: int
) -> Tuple[
    Dict[int, List[Tuple[float, float]]], Dict[int, List[Tuple[float, float, int]]]
]:
    """Replay fault records into per-rid and per-mem dead windows.

    A memory dies when its last alive resource detaches (host never
    dies), and revives when any resource on it re-attaches — the same
    shared-memory rule the fault manager applies, re-derived from the
    static machine shape.  Memory windows carry the seq of the detach
    record that killed them, so salvage effects replay in log order.
    """
    mem_of = {r["rid"]: r["mem"] for r in resources}
    alive: Dict[int, bool] = {r["rid"]: True for r in resources}
    rid_windows: Dict[int, List[Tuple[float, float]]] = {}
    mem_windows: Dict[int, List[Tuple[float, float, int]]] = {}
    rid_open: Dict[int, float] = {}
    mem_open: Dict[int, Tuple[float, int]] = {}
    for rec in sorted(log.faults, key=lambda f: (f.t, f.seq)):
        rid = rec.rid
        mem = mem_of.get(rid)
        if rec.event == "detach":
            if rid in rid_open:
                continue
            rid_open[rid] = rec.t
            alive[rid] = False
            if (
                mem is not None
                and mem != host
                and mem not in mem_open
                and not any(
                    alive[r["rid"]] for r in resources if r["mem"] == mem
                )
            ):
                mem_open[mem] = (rec.t, rec.seq)
        elif rec.event == "attach":
            if rid in rid_open:
                rid_windows.setdefault(rid, []).append((rid_open.pop(rid), rec.t))
            alive[rid] = True
            if mem is not None and mem in mem_open:
                t0, seq0 = mem_open.pop(mem)
                mem_windows.setdefault(mem, []).append((t0, rec.t, seq0))
    for rid, t0 in rid_open.items():
        rid_windows.setdefault(rid, []).append((t0, math.inf))
    for mem, (t0, seq0) in mem_open.items():
        mem_windows.setdefault(mem, []).append((t0, math.inf, seq0))
    return rid_windows, mem_windows


def _verify_exact(log: AuditLog) -> List[Finding]:
    out: List[Finding] = []
    machine = log.machine or {}
    resources = machine.get("resources", [])
    host = int(machine.get("host_mem", 0))
    capacity = int(machine.get("capacity") or 0)
    cancel_stale = bool(machine.get("cancel_stale"))
    mem_of_rid = {r["rid"]: r["mem"] for r in resources}

    max_t = max(
        [r.end for r in log.execs]
        + [h.done for h in log.hops]
        + [log.result.get("makespan", 0.0), 1.0]
    )
    eps = 1e-9 * max(1.0, max_t)

    exec_of = _exec_index(log, out)
    _check_bytes(log, out)

    # arrival / admission ------------------------------------------------
    arrive_at = {r.gid: r.t for r in log.arrivals}
    admit_at = {r.gid: r.t for r in log.admits}
    rejected_at = {r.gid: r.t for r in log.rejects}
    for gid in rejected_at:
        if gid in admit_at:
            out.append(
                Finding(
                    "ARRIVAL",
                    "error",
                    f"graph {gid} carries both an admit and a reject record",
                )
            )
    for rec in log.execs:
        ginfo = log.graphs.get(rec.gid)
        submit = (
            float(ginfo.get("submit_at", 0.0)) if ginfo is not None else None
        )
        t0 = arrive_at.get(rec.gid, submit)
        if t0 is not None and rec.start < t0 - eps:
            out.append(
                Finding(
                    "ARRIVAL",
                    "error",
                    f"g{rec.gid}/t{rec.tid} starts at {rec.start:.6g} before "
                    f"the graph's arrival at {t0:.6g}",
                )
            )
        ta = admit_at.get(rec.gid)
        if ta is not None and rec.start < ta - eps:
            out.append(
                Finding(
                    "ARRIVAL",
                    "error",
                    f"g{rec.gid}/t{rec.tid} starts at {rec.start:.6g} before "
                    f"the graph was admitted at {ta:.6g}",
                )
            )
        if rec.gid in rejected_at:
            out.append(
                Finding(
                    "ARRIVAL",
                    "error",
                    f"g{rec.gid}/t{rec.tid} executed but admission control "
                    f"rejected graph {rec.gid} at {rejected_at[rec.gid]:.6g}",
                )
            )
    # claimed per-graph admission accounting must agree with the records
    pg = log.result.get("per_graph", {})
    for gid in log.graphs:
        info = pg.get(gid, pg.get(str(gid)))
        if info is None:
            continue
        claimed_admit = info.get("admit_at")
        ta = admit_at.get(gid)
        if (
            claimed_admit is not None
            and ta is not None
            and not math.isclose(
                float(claimed_admit), ta, rel_tol=1e-9, abs_tol=eps
            )
        ):
            out.append(
                Finding(
                    "ARRIVAL",
                    "error",
                    f"graph {gid} claims admit_at {float(claimed_admit):.6g} "
                    f"but the admit record says {ta:.6g}",
                )
            )
        if bool(info.get("rejected")) != (gid in rejected_at):
            out.append(
                Finding(
                    "ARRIVAL",
                    "error",
                    f"graph {gid} claimed rejected={bool(info.get('rejected'))} "
                    "but the reject records disagree",
                )
            )

    # static context -----------------------------------------------------
    sizes: Dict[Tuple[int, str], int] = {}
    for gid, ginfo in log.graphs.items():
        for accesses in ginfo["tasks"]:
            for name, size, _mode in accesses:
                sizes[(gid, name)] = size

    # precedence ---------------------------------------------------------
    for gid, ginfo in log.graphs.items():
        preds = derive_edges(ginfo["tasks"])
        for tid, plist in enumerate(preds):
            rec = exec_of.get((gid, tid))
            if rec is None:
                continue
            for pid in plist:
                prec = exec_of.get((gid, pid))
                if prec is None:
                    continue
                if rec.start < prec.end - eps:
                    out.append(
                        Finding(
                            "PRECEDENCE",
                            "error",
                            f"g{gid}/t{tid} starts at {rec.start:.6g} before "
                            f"predecessor t{pid} completes at {prec.end:.6g}",
                        )
                    )

    # fault windows ------------------------------------------------------
    rid_windows, mem_windows = _fault_windows(log, resources, host)

    def _mem_dead_at(mem: int, t: float) -> bool:
        for t0, t1, _seq0 in mem_windows.get(mem, ()):  # strictly inside
            if t0 + eps < t < t1 - eps:
                return True
        return False

    for rec in log.execs:
        for t0, t1 in rid_windows.get(rec.rid, ()):
            if t0 + eps < rec.start < t1 - eps:
                out.append(
                    Finding(
                        "DEAD_WINDOW",
                        "error",
                        f"g{rec.gid}/t{rec.tid} starts at {rec.start:.6g} inside "
                        f"dead window ({t0:.6g}, {t1:.6g}) of resource {rec.rid}",
                    )
                )

    # notice grace windows -----------------------------------------------
    if log.notices:
        fault_ts: Dict[int, List[float]] = {}
        for f in log.faults:
            fault_ts.setdefault(f.rid, []).append(f.t)
        for ts in fault_ts.values():
            ts.sort()
        for note in log.notices:
            # the grace window closes at the first fault event after the
            # notice (the promised detach, or an attach cancelling it);
            # if none was recorded, the promised death time bounds it
            ts = fault_ts.get(note.rid, [])
            i = bisect_right(ts, note.t)
            end = ts[i] if i < len(ts) else note.death_at
            for rec in log.execs:
                if rec.rid != note.rid:
                    continue
                if note.t + eps < rec.start < end - eps:
                    out.append(
                        Finding(
                            "NOTICE_GRACE",
                            "error",
                            f"g{rec.gid}/t{rec.tid} starts at {rec.start:.6g} "
                            f"inside notice window ({note.t:.6g}, {end:.6g}) "
                            f"of resource {note.rid}",
                        )
                    )

    # retry / timeout accounting -----------------------------------------
    for kind, recs, claimed_key in (
        ("retry", log.retries, "n_retries"),
        ("resource", log.timeouts, "n_timeouts"),
    ):
        hops = [h for h in log.hops if h.kind == kind]
        if hops or recs:
            hop_bytes = sum(h.nbytes for h in hops)
            rec_bytes = sum(r.nbytes for r in recs)
            if len(hops) != len(recs) or hop_bytes != rec_bytes:
                out.append(
                    Finding(
                        "RETRY_BYTES",
                        "error",
                        f"{len(hops)} '{kind}' hops ({hop_bytes} bytes) vs "
                        f"{len(recs)} records ({rec_bytes} bytes): every "
                        "re-attempt must be re-charged on the wire",
                    )
                )
        n_claimed = log.result.get(claimed_key)
        if n_claimed is not None and len(recs) != n_claimed:
            out.append(
                Finding(
                    "RETRY_BYTES",
                    "error",
                    f"claimed {claimed_key} {n_claimed} != "
                    f"{len(recs)} recorded events",
                )
            )
    if log.retries or log.timeouts:
        land_ts: Dict[Tuple[int, str, int], List[float]] = {}
        for land in log.landings:
            land_ts.setdefault((land.gid, land.name, land.mem), []).append(land.t)
        for ts in land_ts.values():
            ts.sort()

        def _completes(recs: Sequence[Any], what: str) -> None:
            for rec in recs:
                ts = land_ts.get((rec.gid, rec.name, rec.mem))
                if not ts or ts[-1] < rec.t - eps:
                    out.append(
                        Finding(
                            "TRANSFER_COMPLETES",
                            "error",
                            f"g{rec.gid}/{rec.name} {what} at t={rec.t:.6g} "
                            f"toward memory {rec.mem} but no landing was "
                            "recorded at or after it",
                        )
                    )

        _completes(log.retries, "retried")
        _completes(log.timeouts, "timed out")

    # write-end times per datum, for version-at-time queries -------------
    write_ends: Dict[Tuple[int, str], List[float]] = {}
    for rec in sorted(log.execs, key=lambda r: (r.end, r.seq)):
        ginfo = log.graphs.get(rec.gid)
        if ginfo is None or not (0 <= rec.tid < len(ginfo["tasks"])):
            continue
        _reads, writes = _reads_writes(ginfo["tasks"][rec.tid])
        for name in writes:
            write_ends.setdefault((rec.gid, name), []).append(rec.end)

    def _version_at(gid: int, name: str, t: float) -> int:
        ends = write_ends.get((gid, name))
        if not ends:
            return 0
        # writes completed at or before t: a request issued at the very
        # instant a write completes sees the post-write state (the engine
        # processes the completion, then the request, in the same event)
        return bisect_right(ends, t + eps)

    # residency reconstruction -------------------------------------------
    # event kinds replayed in (t, seq) order:
    #   land   -> open copy (version as of request time)
    #   exec   -> write effects: written data becomes exclusive at target
    #   evict  -> drop copy, dirty adds host copy (same version)
    #   fault  -> memory death salvages sole copies to host, drops the rest
    events: List[Tuple[float, int, str, Any]] = []
    for land in log.landings:
        events.append((land.t, land.seq, "land", land))
    for rec in log.execs:
        events.append((rec.end, rec.seq, "exec", rec))
    for ev in log.evictions:
        events.append((ev.t, ev.seq, "evict", ev))
    for mem, wins in mem_windows.items():
        for t0, _t1, seq0 in wins:
            events.append((t0, seq0, "memdeath", mem))
    events.sort(key=lambda e: (e[0], e[1]))

    copies: Dict[Tuple[int, str], Dict[int, _Intervals]] = {}
    live: Dict[Tuple[int, str], Dict[int, int]] = {}  # mem -> version
    resident_bytes: Dict[int, int] = {}
    high_water: Dict[int, int] = {}
    cap_reported: Set[int] = set()

    def _ivs(gid: int, name: str, mem: int) -> _Intervals:
        return copies.setdefault((gid, name), {}).setdefault(mem, _Intervals())

    def _add_copy(gid: int, name: str, mem: int, t: float, version: int) -> None:
        key = (gid, name)
        mems = live.setdefault(key, {})
        fresh = mem not in mems
        mems[mem] = version
        _ivs(gid, name, mem).open(t, version)
        if fresh and mem != host:
            size = sizes.get(key, 0)
            resident_bytes[mem] = resident_bytes.get(mem, 0) + size
            high_water[mem] = max(high_water.get(mem, 0), resident_bytes[mem])
            if capacity and resident_bytes[mem] > capacity and mem not in cap_reported:
                cap_reported.add(mem)
                out.append(
                    Finding(
                        "CAPACITY",
                        "error",
                        f"memory {mem} resident bytes {resident_bytes[mem]} exceed "
                        f"capacity {capacity} at t={t:.6g}",
                    )
                )

    def _drop_copy(gid: int, name: str, mem: int, t: float) -> Optional[int]:
        key = (gid, name)
        mems = live.get(key, {})
        version = mems.pop(mem, None)
        if version is None:
            return None
        ivs = copies.get(key, {}).get(mem)
        if ivs is not None:
            ivs.close(t)
        if mem != host:
            resident_bytes[mem] = resident_bytes.get(mem, 0) - sizes.get(key, 0)
        return version

    # all data starts resident at host, version 0
    for (gid, name) in sizes:
        t0 = log.graphs[gid].get("submit_at", 0.0)
        _add_copy(gid, name, host, t0 - 1.0, 0)

    for t, _seq, kind, payload in events:
        if kind == "land":
            land = payload
            if not land.landed:
                continue
            if _mem_dead_at(land.mem, t):
                out.append(
                    Finding(
                        "DEAD_LANDING",
                        "error",
                        f"copy of g{land.gid}/{land.name} recorded as landed in "
                        f"dead memory {land.mem} at t={t:.6g}",
                    )
                )
            t_req = land.t_req if land.t_req is not None else t
            _add_copy(land.gid, land.name, land.mem, t, _version_at(land.gid, land.name, t_req))
        elif kind == "exec":
            rec = payload
            ginfo = log.graphs.get(rec.gid)
            if ginfo is None or not (0 <= rec.tid < len(ginfo["tasks"])):
                continue
            _reads, writes = _reads_writes(ginfo["tasks"][rec.tid])
            target = host if rec.wrote_host else rec.mem
            for name in writes:
                key = (rec.gid, name)
                for mem in list(live.get(key, {})):
                    if mem != target:
                        _drop_copy(rec.gid, name, mem, t)
                new_ver = len(
                    [e for e in write_ends.get(key, ()) if e <= t + eps]
                )
                if target in live.get(key, {}):
                    # exclusive overwrite in place: close + reopen at new version
                    _ivs(rec.gid, name, target).close(t)
                    live[key][target] = new_ver
                    _ivs(rec.gid, name, target).open(t, new_ver)
                else:
                    _add_copy(rec.gid, name, target, t, new_ver)
        elif kind == "evict":
            ev = payload
            version = _drop_copy(ev.gid, ev.name, ev.mem, t)
            if ev.dirty and version is not None:
                _add_copy(ev.gid, ev.name, host, t, version)
        elif kind == "memdeath":
            mem = payload
            for key, mems in list(live.items()):
                if mem in mems:
                    sole = len(mems) == 1
                    version = _drop_copy(key[0], key[1], mem, t)
                    if sole and version is not None:
                        _add_copy(key[0], key[1], host, t, version)

    # data arrival + stale reads -----------------------------------------
    stale_sev = "error" if cancel_stale else "warning"
    for rec in log.execs:
        ginfo = log.graphs.get(rec.gid)
        if ginfo is None or not (0 <= rec.tid < len(ginfo["tasks"])):
            continue
        reads, _writes = _reads_writes(ginfo["tasks"][rec.tid])
        for name in reads:
            ivs = copies.get((rec.gid, name), {}).get(rec.mem)
            iv = ivs.covering(rec.start, eps) if ivs is not None else None
            if iv is None:
                out.append(
                    Finding(
                        "DATA_ARRIVAL",
                        "error",
                        f"g{rec.gid}/t{rec.tid} reads {name} at t={rec.start:.6g} "
                        f"but no copy was resident in memory {rec.mem}",
                    )
                )
                continue
            current = _version_at(rec.gid, name, rec.start)
            if iv[2] < current:
                out.append(
                    Finding(
                        "STALE_READ",
                        stale_sev,
                        f"g{rec.gid}/t{rec.tid} reads {name} version "
                        f"{int(iv[2])} in memory {rec.mem} at t={rec.start:.6g} "
                        f"but version {current} was already written"
                        + (
                            ""
                            if cancel_stale
                            else " (cancel-stale off: documented modeling artifact)"
                        ),
                    )
                )

    # makespan ------------------------------------------------------------
    per_graph = log.result.get("per_graph", {})
    for gid, ginfo in log.graphs.items():
        info = per_graph.get(gid, per_graph.get(str(gid)))
        if info is None:
            continue
        ends = [r.end for r in log.execs if r.gid == gid]
        if not ends:
            continue
        finish = float(info.get("finish", math.nan))
        if not math.isclose(finish, max(ends), rel_tol=1e-9, abs_tol=eps):
            out.append(
                Finding(
                    "MAKESPAN",
                    "error",
                    f"graph {gid} claims finish {finish:.6g} but last recorded "
                    f"execution ends at {max(ends):.6g}",
                )
            )
    return out


# ----------------------------------------------------------------------
# surrogate engine
# ----------------------------------------------------------------------
def _verify_surrogate(log: AuditLog) -> List[Finding]:
    out: List[Finding] = []
    machine = log.machine or {}
    resources = machine.get("resources", [])
    valid = {r["rid"]: bool(r.get("valid", True)) for r in resources}

    max_t = max([r.end for r in log.execs] + [1.0])
    # f32 episode state: relative tolerance scaled to the horizon
    eps = 1e-3 * max(1.0, max_t) + 1e-6

    exec_of = _exec_index(log, out)
    _check_bytes(log, out, rel_tol=1e-3)

    for gid, ginfo in log.graphs.items():
        preds = derive_edges(ginfo["tasks"])
        for tid, plist in enumerate(preds):
            rec = exec_of.get((gid, tid))
            if rec is None:
                continue
            for pid in plist:
                prec = exec_of.get((gid, pid))
                if prec is None:
                    continue
                if rec.start < prec.end - eps:
                    out.append(
                        Finding(
                            "PRECEDENCE",
                            "error",
                            f"g{gid}/t{tid} starts at {rec.start:.6g} before "
                            f"predecessor t{pid} completes at {prec.end:.6g}",
                        )
                    )

    for rec in log.execs:
        if not valid.get(rec.rid, True):
            out.append(
                Finding(
                    "RESOURCE_VALID",
                    "error",
                    f"g{rec.gid}/t{rec.tid} placed on invalid resource {rec.rid}",
                )
            )

    per_graph = log.result.get("per_graph", {})
    for gid in log.graphs:
        info = per_graph.get(gid, per_graph.get(str(gid)))
        if info is None:
            continue
        ends = [r.end for r in log.execs if r.gid == gid]
        if not ends:
            continue
        finish = float(info.get("finish", math.nan))
        if not math.isclose(finish, max(ends), rel_tol=1e-3, abs_tol=eps):
            out.append(
                Finding(
                    "MAKESPAN",
                    "error",
                    f"graph {gid} claims makespan {finish:.6g} but last placement "
                    f"ends at {max(ends):.6g}",
                )
            )
    return out
