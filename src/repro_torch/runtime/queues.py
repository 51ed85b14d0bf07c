"""Per-worker ready queues and the pop/push/steal protocol (paper §2.2).

Each worker owns a deque of ready tasks: the owner pops from one end
(newest-first under ``owner_lifo``, oldest-first otherwise) and thieves
always take the *oldest* task from the other end. Victim eligibility is
the backlog rule the paper describes: a queue of ≥ 2, or ≥ 1 while the
victim is actually running — a lone task whose input transfers are already
in flight is not worth stealing, its copies are on their way to the
victim's memory.

The placing strategies (HEFT, DADA) push every ready task explicitly and
do not steal. :class:`WorkSteal` lives here because it *is* the queue
protocol with no model on top: the paper's "model oblivious" baseline
(§4.3). Counterpart of ``repro.runtime.queues``.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional


class Worker:
    """One worker: a ready deque plus its running/blocked state."""

    __slots__ = ("rid", "queue", "running", "run_start", "blocked_on", "pins")

    def __init__(self, rid: int) -> None:
        self.rid = rid
        self.queue: deque = deque()
        self.running = None
        self.run_start: float = 0.0
        self.blocked_on: int = 0  # pending input transfers for head task
        # (mem, [data ids], ctx) pinned against eviction while the head
        # task is blocked or running; None outside capacity-bounded runs
        self.pins: Optional[tuple] = None


def eligible_victims(workers: List[Worker], thief_rid: int) -> List[Worker]:
    """Steal-eligible victims: a backlog of >=2, or >=1 while running."""
    return [
        w
        for w in workers
        if w.rid != thief_rid
        and (len(w.queue) >= 2 or (len(w.queue) >= 1 and w.running is not None))
    ]


class WorkSteal:
    """Locality-oblivious random work stealing (paper §4.3).

    ``place`` pushes newly-ready tasks onto the completing worker's own
    queue (the owner executes newest-first); idle workers steal the oldest
    task from a randomly selected victim. No performance or transfer
    model is used, so nothing is scored and nothing runs on the card: a
    ``ws`` run is host code on any device, as the reference's ``ws`` uses
    no scoring backend either.
    """

    name = "ws"
    allow_steal = True
    owner_lifo = True

    def init(self, sim) -> None:
        pass

    def place(self, sim, ready, src: Optional[int]) -> None:
        rid = src if src is not None else 0
        for t in ready:
            sim.push(t, rid)

    def score_matrix(self, sim, ready) -> None:
        """Work stealing is model-oblivious: there is no score matrix."""
        return None
