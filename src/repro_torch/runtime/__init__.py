"""``repro_torch.runtime`` — the event-driven engine in layers: the event
heap (``events``), worker queues (``queues``), link timing and transfer
routing (``transfers``), counters and results (``metrics``) and the event
loop (``engine``)."""
from .engine import Engine, GraphContext, Strategy
from .metrics import ScheduledInterval, SimResult

__all__ = ["Engine", "GraphContext", "ScheduledInterval", "SimResult", "Strategy"]
