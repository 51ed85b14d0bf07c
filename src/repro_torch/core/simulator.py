"""The single-graph simulation facade over :class:`repro_torch.runtime.engine.Engine`.

Construct with one graph, ``run()`` one :class:`SimResult` — the
counterpart of ``repro.core.simulator.Simulator``, with the reference's
settings as arguments: the capacity-bounded memories (``mem_capacity``
bytes per device memory, 0: unbounded; ``eviction``, ``"lru"`` or
``"affinity"``), the faults (``churn``, ``fault_mode``, ``fault_trace``,
``notice_s``; :meth:`Engine.inject` schedules one) and the flaky links
(``link_flake``, ``retry_max``, ``backoff_s``) and stale-transfer
cancellation (``cancel_stale``), with the reference's defaults. ``SimResult.faults`` holds the fault counters of a run with a
fault source or flaky links.
"""
from __future__ import annotations

from typing import Optional

from ..runtime.engine import Engine, GraphContext, Strategy
from ..runtime.metrics import ScheduledInterval, SimResult
from .dag import TaskGraph
from .machine import MachineModel
from .perfmodel import TransferModel

__all__ = ["ScheduledInterval", "SimResult", "Simulator", "Strategy"]


class Simulator(Engine):
    """One task graph on one machine: the paper's simulation setup."""

    def __init__(
        self,
        graph: TaskGraph,
        machine: MachineModel,
        strategy: Strategy,
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
    ) -> None:
        super().__init__(
            machine, strategy, seed=seed, noise=noise,
            transfer_model=transfer_model, audit=audit,
            mem_capacity=mem_capacity, eviction=eviction, churn=churn,
            fault_mode=fault_mode, fault_trace=fault_trace, notice_s=notice_s,
            link_flake=link_flake, retry_max=retry_max, backoff_s=backoff_s,
            cancel_stale=cancel_stale,
        )
        self._primary: GraphContext = self.submit(graph)

    def request_transfer(self, name: str, size: int, dst_mem: int):
        """Ensure a valid copy of ``name`` will exist at ``dst_mem``;
        returns the completion time, or None if already resident."""
        return self.transfers.request(self._primary, name, size, dst_mem, self.now)

    def run(self) -> SimResult:
        self._run_loop()
        m = self.metrics
        return SimResult(
            makespan=self.now,
            total_bytes=m.total_bytes,
            n_transfers=m.n_transfers,
            busy=dict(m.busy),
            intervals=m.intervals,
            strategy=self.strategy.name,
            total_flops=self._primary.graph.total_flops(),
            n_events=m.n_events,
            n_steals=m.n_steals,
            faults=self.fault_summary(),
        )
