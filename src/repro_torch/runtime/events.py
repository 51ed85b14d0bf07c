"""Event heap + clock: the ordering backbone of the engine.

Events are ``(time, seq, kind, payload)`` tuples on a binary heap. ``seq``
is a strictly increasing posting counter, so ties in ``time`` resolve in
posting order and payloads are never compared. Preserving the exact
posting order is part of the bit-for-bit contract with ``repro``'s
engine: two events at the same simulated time fire in the same order.
"""
from __future__ import annotations

import heapq
from typing import Any, List, Tuple

Event = Tuple[float, int, str, Any]


class EventQueue:
    """A posting-order tie-break event heap (``heap`` is popped directly
    by the engine's run loop)."""

    __slots__ = ("heap", "seq")

    def __init__(self) -> None:
        self.heap: List[Event] = []
        self.seq = 0

    def post(self, t: float, kind: str, payload: Any) -> None:
        """Schedule ``(kind, payload)`` at simulated time ``t``."""
        self.seq += 1
        heapq.heappush(self.heap, (t, self.seq, kind, payload))
