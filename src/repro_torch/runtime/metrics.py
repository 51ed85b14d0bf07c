"""Run metrics: counters, execution intervals and :class:`SimResult`.

One :class:`Metrics` instance per engine accumulates the machine-global
counters (transferred bytes, transfer/steal/event counts, per-worker busy
time, the interval timeline) and, under a memory capacity, the
evictions and their write-back traffic."""
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
    n_steals: int = 0

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
