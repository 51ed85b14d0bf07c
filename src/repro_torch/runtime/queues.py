"""Per-worker ready queues (paper §2.2).

Each worker owns a deque of ready tasks and pops the oldest first: the
placing strategies of this package (HEFT, DADA) push every ready task
explicitly and do not steal.
"""
from __future__ import annotations

from collections import deque


class Worker:
    """One worker: a ready deque plus its running/blocked state."""

    __slots__ = ("rid", "queue", "running", "run_start", "blocked_on")

    def __init__(self, rid: int) -> None:
        self.rid = rid
        self.queue: deque = deque()
        self.running = None
        self.run_start: float = 0.0
        self.blocked_on: int = 0  # pending input transfers for head task
