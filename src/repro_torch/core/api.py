"""Public entry point of the scheduling core."""
from __future__ import annotations

from ..sched.registry import resolve
from .dag import TaskGraph
from .machine import MachineModel
from .simulator import SimResult, Simulator


def run_simulation(
    graph: TaskGraph,
    machine: MachineModel,
    strategy,
    seed: int = 0,
    noise: float = 0.03,
) -> SimResult:
    """Simulate ``graph`` on ``machine`` under ``strategy`` (a strategy
    object, or a registry spec such as ``"dada?alpha=0.5&use_cp=1"``,
    which builds it for the card)."""
    sim = Simulator(graph, machine, resolve(strategy), seed=seed, noise=noise)
    return sim.run()
