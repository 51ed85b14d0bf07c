"""Core: the task-graph model, machine and performance models, the
simulator facade, the HEFT / DADA strategies, the seeded repetitions
(``run_many``) and the batched surrogate episodes (``run_batch``)."""
from .api import BatchResult, Summary, cached_graph, run_batch, run_many, run_simulation
from .dada import DADA, DualApprox
from .dag import Access, DataObject, GraphArrays, Mode, Task, TaskGraph
from .heft import HEFT
from .machine import HOST_MEM, LinkModel, MachineModel, Resource, ResourceClass, make_machine
from .simulator import SimResult, Simulator, Strategy

__all__ = [
    "Access", "BatchResult", "DADA", "DataObject", "DualApprox", "GraphArrays", "HEFT",
    "HOST_MEM", "LinkModel", "MachineModel", "Mode", "Resource",
    "ResourceClass", "SimResult", "Simulator", "Strategy", "Summary", "Task",
    "TaskGraph", "cached_graph", "make_machine", "run_batch", "run_many", "run_simulation",
]
