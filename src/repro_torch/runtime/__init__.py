"""``repro_torch.runtime`` — the event-driven engine in layers: the event
heap (``events``), worker queues (``queues``), link timing, transfer
routing and flaky links (``transfers``), capacity-bounded memories
(``memory``), resource faults and recovery (``faults``), preemption
traces (``traces``), counters, results and the recovery report
(``metrics``) and the event loop (``engine``)."""
from .engine import Engine, GraphContext, Strategy
from .faults import FaultManager
from .metrics import ScheduledInterval, SimResult, recovery_report
from .traces import FAULT_EVENTS, FAULT_MODES, FaultEvent, load_trace, save_trace

__all__ = [
    "Engine", "FAULT_EVENTS", "FAULT_MODES", "FaultEvent", "FaultManager", "GraphContext",
    "ScheduledInterval", "SimResult", "Strategy", "load_trace", "recovery_report", "save_trace",
]
