"""Run metrics: counters, execution intervals and :class:`SimResult`.

One :class:`Metrics` instance per engine accumulates the machine-global
counters (transferred bytes, transfer/steal/event counts, per-worker busy
time, the interval timeline), under a memory capacity the evictions and
their write-back traffic, and under faults (:mod:`repro_torch.runtime.faults`)
or flaky links the recovery counters, which :func:`recovery_report` reads
against a fault-free baseline. In serving mode the arrival and admission
counters, which :func:`serving_report` aggregates with the per-tenant
rows (:func:`percentile`, :func:`jain_fairness`)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..core.machine import MachineModel


@dataclass(slots=True)
class ScheduledInterval:
    tid: int
    rid: int
    start: float
    end: float


@dataclass
class SimResult:
    makespan: float
    total_bytes: int
    n_transfers: int
    busy: Dict[int, float]
    intervals: List[ScheduledInterval]
    strategy: str
    total_flops: float
    n_events: int = 0
    n_steals: int = 0
    # the fault and recovery counters (Metrics.fault_summary); None unless
    # a fault source or flaky links were on
    faults: Optional[Dict[str, float]] = None
    # arrival accounting: when the graph was submitted and admitted, and
    # whether admission control let it in (serving mode)
    submit_at: float = 0.0
    admit_at: float = 0.0
    admitted: bool = True

    @property
    def gflops(self) -> float:
        if self.makespan <= 0:
            return 0.0
        return self.total_flops / self.makespan / 1e9

    @property
    def gbytes(self) -> float:
        return self.total_bytes / 1e9


class Metrics:
    """Engine-global counters."""

    __slots__ = (
        "total_bytes", "n_transfers", "n_steals", "n_events", "busy", "intervals",
        "n_evictions", "n_writebacks", "writeback_bytes",
        "n_detaches", "n_attaches", "n_killed", "n_requeued",
        "n_evacuations", "evacuated_bytes", "wasted_s",
        "n_notices", "n_proactive", "proactive_bytes",
        "n_retries", "n_timeouts", "retry_delay_s",
        "n_arrivals", "n_admitted", "n_rejected", "n_deferred",
    )

    def __init__(self, machine: MachineModel) -> None:
        self.total_bytes = 0
        self.n_transfers = 0
        self.n_steals = 0
        self.n_events = 0
        self.busy: Dict[int, float] = {r.rid: 0.0 for r in machine.resources}
        self.intervals: List[ScheduledInterval] = []
        # eviction traffic (capacity-bounded memories only)
        self.n_evictions = 0
        self.n_writebacks = 0
        self.writeback_bytes = 0
        # faults and recovery (repro_torch.runtime.faults)
        self.n_detaches = 0
        self.n_attaches = 0
        self.n_killed = 0  # running tasks aborted (kill and requeue)
        self.n_requeued = 0  # tasks re-activated off dead workers
        self.n_evacuations = 0  # sole copies salvaged to host at a detach
        self.evacuated_bytes = 0
        self.wasted_s = 0.0  # partial executions discarded by kills
        # preemption notices and flaky-link retries
        self.n_notices = 0
        self.n_proactive = 0  # sole copies replicated inside a notice window
        self.proactive_bytes = 0
        self.n_retries = 0  # failed hops retried with backoff
        self.n_timeouts = 0  # retry budget exhausted: re-sourced
        self.retry_delay_s = 0.0  # total backoff delay
        # serving mode: arrivals and admission control (repro_torch.runtime.load)
        self.n_arrivals = 0  # tenant graphs that reached the machine
        self.n_admitted = 0  # ... admitted past admission control
        self.n_rejected = 0  # ... turned away (working set against capacity)
        self.n_deferred = 0  # deferrals (one arrival may defer many times)

    def fault_summary(self) -> Dict[str, float]:
        """The fault counters as a plain dict (``SimResult.faults``)."""
        return {
            "n_detaches": self.n_detaches,
            "n_attaches": self.n_attaches,
            "n_killed": self.n_killed,
            "n_requeued": self.n_requeued,
            "n_evacuations": self.n_evacuations,
            "evacuated_bytes": self.evacuated_bytes,
            "wasted_s": self.wasted_s,
            "n_notices": self.n_notices,
            "n_proactive": self.n_proactive,
            "proactive_bytes": self.proactive_bytes,
            "n_retries": self.n_retries,
            "n_timeouts": self.n_timeouts,
            "retry_delay_s": self.retry_delay_s,
        }


def recovery_report(faulted: SimResult, baseline: SimResult) -> Dict[str, float]:
    """Recovery metrics of a faulted run against its fault-free baseline
    (same graph, machine, strategy and seed): the makespan and bytes the
    faults cost (``recovery_makespan``, claim C8; ``extra_bytes``, the
    evacuations and the re-transfers included), the slowdown, and the
    faulted run's counters, with the evacuated bytes also under
    ``reactive_evacuated_bytes`` (salvage at death, beside
    ``proactive_bytes``: replication inside a notice window)."""
    out: Dict[str, float] = {
        "makespan": faulted.makespan,
        "baseline_makespan": baseline.makespan,
        "recovery_makespan": faulted.makespan - baseline.makespan,
        "slowdown": (
            faulted.makespan / baseline.makespan if baseline.makespan > 0 else float("inf")
        ),
        "extra_bytes": faulted.total_bytes - baseline.total_bytes,
    }
    if faulted.faults:
        out.update(faulted.faults)
        out["reactive_evacuated_bytes"] = faulted.faults.get("evacuated_bytes", 0)
    return out


# ---------------------------------------------------------------------------
# serving-mode aggregates (repro_torch.runtime.load.run_serving)


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]); 0.0 for empty input.
    Nearest rank, so a reported p99 is a value some tenant experienced."""
    if not values:
        return 0.0
    if not (0.0 <= q <= 100.0):
        raise ValueError(f"percentile q must be in [0, 100], got {q!r}")
    s = sorted(values)
    rank = max(1, -(-len(s) * q // 100))  # ceil(len * q / 100), at least 1
    return float(s[int(rank) - 1])


def jain_fairness(values: List[float]) -> float:
    """Jain's fairness index (Σx)² / (n·Σx²): 1.0 when every tenant was
    treated alike, 1/n when one tenant got everything; 1.0 for empty or
    all-zero input."""
    if not values:
        return 1.0
    total = sum(values)
    sq = sum(v * v for v in values)
    if sq <= 0.0:
        return 1.0
    return (total * total) / (len(values) * sq)


def serving_report(tenants: List[Dict[str, float]]) -> Dict[str, float]:
    """The p50 / p99 and fairness summary of per-tenant serving rows, each
    with ``makespan``, ``slowdown`` (against the tenant's empty-machine
    baseline) and ``queue_delay`` (first start minus submit). Fairness is
    Jain's index over the slowdowns."""
    slow = [float(r["slowdown"]) for r in tenants]
    qd = [float(r["queue_delay"]) for r in tenants]
    mk = [float(r["makespan"]) for r in tenants]
    n = len(tenants)
    return {
        "n_tenants": n,
        "p50_makespan": percentile(mk, 50),
        "p99_makespan": percentile(mk, 99),
        "p50_slowdown": percentile(slow, 50),
        "p99_slowdown": percentile(slow, 99),
        "mean_slowdown": (sum(slow) / n) if n else 0.0,
        "p50_queue_delay": percentile(qd, 50),
        "p99_queue_delay": percentile(qd, 99),
        "jain_fairness": jain_fairness(slow),
    }
