"""Run metrics: counters, execution intervals and :class:`SimResult`."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

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


class Metrics:
    """Engine-global counters."""

    __slots__ = ("total_bytes", "n_transfers", "n_events", "busy", "intervals")

    def __init__(self, machine: MachineModel) -> None:
        self.total_bytes = 0
        self.n_transfers = 0
        self.n_events = 0
        self.busy: Dict[int, float] = {r.rid: 0.0 for r in machine.resources}
        self.intervals: List[ScheduledInterval] = []
