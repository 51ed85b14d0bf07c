"""``repro_torch.runtime`` — the event-driven engine in layers: the event
heap (``events``), worker queues (``queues``), link timing, transfer
routing and flaky links (``transfers``), capacity-bounded memories
(``memory``), resource faults and recovery (``faults``), preemption
traces (``traces``), the serving pool with dirty-row rescoring
(``rescore``), open-loop serving load and its driver (``load``),
counters, results, the recovery report and the serving aggregates
(``metrics``) and the event loop (``engine``).

The fault-trace helpers keep the names ``load_trace`` / ``save_trace``;
the arrival-trace ones are exported as ``load_arrival_trace`` /
``save_arrival_trace``, as the reference exports them."""
import repro_torch.core  # noqa: F401  (the core imports the engine first: breaks the cycle)

from .engine import Engine, GraphContext, Strategy
from .events import EventQueue
from .faults import FaultManager
from .load import ADMISSION_MODES, ARRIVAL_PROCESSES, Arrival, default_catalog, make_arrivals
from .load import load_trace as load_arrival_trace
from .load import run_serving
from .load import save_trace as save_arrival_trace
from .memory import MemoryManager, predicted_eviction_bytes
from .metrics import (
    Metrics,
    ScheduledInterval,
    SimResult,
    jain_fairness,
    percentile,
    recovery_report,
    serving_report,
)
from .queues import Worker, WorkSteal, eligible_victims
from .rescore import RESCORE_MODES, ServingScheduler
from .traces import FAULT_EVENTS, FAULT_MODES, FaultEvent, load_trace, save_trace
from .transfers import TransferEngine

__all__ = [
    "ADMISSION_MODES", "ARRIVAL_PROCESSES", "Arrival", "Engine", "EventQueue", "FAULT_EVENTS",
    "FAULT_MODES", "FaultEvent", "FaultManager", "GraphContext", "MemoryManager", "Metrics",
    "RESCORE_MODES", "ScheduledInterval", "ServingScheduler", "SimResult", "Strategy",
    "TransferEngine", "Worker", "WorkSteal", "default_catalog", "eligible_victims",
    "jain_fairness", "load_arrival_trace", "load_trace", "make_arrivals", "percentile",
    "predicted_eviction_bytes", "recovery_report", "run_serving", "save_arrival_trace",
    "save_trace", "serving_report",
]
