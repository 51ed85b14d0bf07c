"""Execute a data-flow task graph on torch tensors.

Counterpart of ``repro.linalg.execute``. Two modes:
  * ``execute_graph``: program (topological) order — the semantic reference;
  * ``execute_schedule``: replay the exact per-worker interval order produced
    by a simulation, asserting it is precedence-safe. Identical results prove
    the scheduler's orders are *valid linearizations* of the DAG.

Task bodies receive the current tensors of their accesses (in access order)
and return new tensors for their write accesses (in order); they never
write into their inputs, so the caller's tensors are left as they were.
The tensors stay on the device they came on.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.dag import TaskGraph
from ..core.simulator import SimResult


def _run_task(task, store: Dict[str, torch.Tensor]) -> None:
    if task.fn is None:
        raise ValueError(f"{task} has no executable body")
    # convention: bodies receive tensors for *reading* accesses (R/RW) in
    # access order and return tensors for *writing* accesses (W/RW) in order
    args = [store[a.data.name] for a in task.accesses if a.mode.reads]
    outs = task.fn(*args)
    writes = [a.data.name for a in task.accesses if a.mode.writes]
    if len(outs) != len(writes):
        raise ValueError(
            f"{task}: body returned {len(outs)} outputs for {len(writes)} writes"
        )
    for name, val in zip(writes, outs):
        store[name] = val


def execute_graph(
    graph: TaskGraph, arrays: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    store = dict(arrays)
    for tid in graph.topo_order():
        _run_task(graph.tasks[tid], store)
    return store


def execute_schedule(
    graph: TaskGraph,
    arrays: Dict[str, torch.Tensor],
    result: SimResult,
) -> Dict[str, torch.Tensor]:
    """Replay a simulated schedule (global start-time order) and check that
    every task starts only after all its predecessors finished."""
    order = sorted(result.intervals, key=lambda iv: (iv.start, iv.tid))
    end_time = {iv.tid: iv.end for iv in result.intervals}
    store = dict(arrays)
    done = set()
    for iv in order:
        for p in graph.pred[iv.tid]:
            if p not in done:
                raise AssertionError(
                    f"schedule violates precedence: task {iv.tid} started at "
                    f"{iv.start} before predecessor {p} finished"
                )
            if end_time[p] > iv.start + 1e-9:
                raise AssertionError(
                    f"overlap: task {iv.tid} starts {iv.start} < pred {p} "
                    f"ends {end_time[p]}"
                )
        _run_task(graph.tasks[iv.tid], store)
        done.add(iv.tid)
    if len(done) != len(graph):
        raise AssertionError("schedule did not execute every task")
    return store
