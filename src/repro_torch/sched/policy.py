"""The ``Policy`` protocol: placement from (ready × resources) score matrices.

Counterpart of ``repro.sched.policy``. HEFT and DADA are two instances of
one mechanism: every placement decision is a function of per-(task ×
resource) completion-time and data-transfer scores. This module makes
that mechanism the extension point:

  * :class:`Policy`: the structural protocol every scheduling policy
    satisfies (the engine calls ``init`` / ``place`` and reads the class
    flags; ``score_matrix`` exposes the policy's scores);
  * :class:`ScoreMatrixPolicy`: a base class whose ``place`` is a generic
    driver: one score matrix per activation, plus the memory pressure
    under a capacity, each task to its argmin resource (optionally
    load-aware, with a tenant's fairness scale);
  * :func:`assign_from_scores`: the pure scores → assignment loop.

HEFT and DADA keep their own ``place`` (the EFT scan, the λ search) and
expose their matrices through the same method.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from ..core.dag import Task
from ..core.perfmodel import class_duration_matrix
from ..core.simulator import Simulator, Strategy
from ..runtime.memory import pressure_rows_for


@runtime_checkable
class Policy(Protocol):
    """Structural interface of a scheduling policy: the strategies satisfy
    it without inheriting from it."""

    name: str
    allow_steal: bool
    owner_lifo: bool

    def init(self, sim: Simulator) -> None:
        """Called once before the simulation starts."""

    def place(self, sim: Simulator, ready: List[Task], src: Optional[int]) -> None:
        """Place newly-ready tasks (the paper's *activate* operation)."""

    def score_matrix(self, sim: Simulator, ready: Sequence[Task]) -> Optional[np.ndarray]:
        """(ready × resources) placement scores, lower = better; ``None``
        for policies that do not score (work stealing)."""


def assign_from_scores(
    scores: np.ndarray,
    *,
    loads: Optional[np.ndarray] = None,
    costs: Optional[np.ndarray] = None,
    capacity: Optional[np.ndarray] = None,
    order: Optional[Sequence[int]] = None,
    return_loads: bool = False,
):
    """Greedy scores → assignment.

    Each item ``i`` (in ``order``, default the given order) goes to the
    column minimizing ``scores[i] + loads``; the chosen column's load then
    grows by ``costs[i, j]`` (default: the score itself), so the driver is
    load-aware whenever ``loads`` is given. ``capacity[j]`` bounds how
    many items a column may take. Ties go to the lowest column index.

    Returns the chosen column per item, in the items' original order
    (plus the final per-column loads with ``return_loads``).
    """
    S = np.asarray(scores, dtype=np.float64)
    n, m = S.shape
    if order is None:
        order = range(n)
    live_loads = None if loads is None else np.asarray(loads, dtype=np.float64).copy()
    remaining = None if capacity is None else np.asarray(capacity, dtype=np.int64).copy()
    choice = np.empty(n, dtype=np.int64)
    for i in order:
        row = S[i] if live_loads is None else S[i] + live_loads
        if remaining is not None:
            row = np.where(remaining > 0, row, np.inf)
        j = int(np.argmin(row))
        if not np.isfinite(row[j]):
            raise ValueError("assign_from_scores: no eligible column left")
        choice[i] = j
        if live_loads is not None:
            live_loads[j] += costs[i, j] if costs is not None else S[i, j]
        if remaining is not None:
            remaining[j] -= 1
    if return_loads:
        if live_loads is None:
            raise ValueError("return_loads requires loads")
        return choice, live_loads
    return choice


class ScoreMatrixPolicy(Strategy):
    """Base class: placement driven by :meth:`score_matrix`.

    Subclasses emit one (ready × resources) score matrix per activation;
    the driver adds the memory pressure (:meth:`pressure_matrix`) and
    assigns each task to its minimum-score resource. With ``load_aware``
    it adds the resources' backlog (``sim.load_ts`` beyond now) to every
    score, charges the chosen resource the task's predicted duration and
    keeps ``sim.load_ts`` up to date, as HEFT and DADA do (paper §2.3).
    """

    allow_steal = False
    owner_lifo = False
    load_aware = False

    def score_matrix(self, sim: Simulator, ready: Sequence[Task]) -> np.ndarray:
        raise NotImplementedError

    def tenant_scale(self, sim, ctx) -> float:
        """Multiplier (> 0) on the backlog term for ``ctx``'s tenant: 1.0
        is plain load-aware placement; fairness policies override it. An
        optional ``charge_tenant(ctx, dur)`` lets a policy account each
        tenant's service."""
        return 1.0

    def pressure_matrix(self, sim: Simulator, ready: Sequence[Task]) -> Optional[np.ndarray]:
        """(ready × resources) memory-pressure penalty in seconds; ``None``
        when the device memories are unbounded. Each entry is the
        predicted eviction bytes placing the task there would force, over
        the link bandwidth."""
        return pressure_rows_for(sim, [t.tid for t in ready], sim.machine.resources)

    def place(self, sim: Simulator, ready: List[Task], src: Optional[int]) -> None:
        tids = [t.tid for t in ready]
        S = np.asarray(self.score_matrix(sim, ready), dtype=np.float64)
        if S.shape != (len(ready), len(sim.machine.resources)):
            raise ValueError(
                f"{self.name}: score matrix shape {S.shape} != "
                f"(ready={len(ready)}, resources={len(sim.machine.resources)})"
            )
        P = self.pressure_matrix(sim, ready)
        if P is not None:
            S = S + P
        if not self.load_aware:
            choice = assign_from_scores(S)
            for i, t in enumerate(ready):
                sim.push(t, int(choice[i]))
            return
        now = sim.now
        offsets = np.array([max(lt - now, 0.0) for lt in sim.load_ts], dtype=np.float64)
        dur = class_duration_matrix(sim, tids)
        ctx = getattr(sim, "_cur", None)
        scale = 1.0 if ctx is None else float(self.tenant_scale(sim, ctx))
        if scale == 1.0:
            choice, loads = assign_from_scores(S, loads=offsets, costs=dur, return_loads=True)
            # charge the placements into the shared completion time-stamps
            for j, load in enumerate(loads):
                sim.load_ts[j] = now + float(load)
        else:
            # the scale biases only the choice: the backlog charged into
            # load_ts stays unscaled, or every other tenant would see a
            # distorted machine
            choice = assign_from_scores(S, loads=offsets * scale, costs=dur * scale)
            for i in range(len(ready)):
                j = int(choice[i])
                sim.load_ts[j] = now + float(offsets[j]) + float(dur[i, j])
                offsets[j] += dur[i, j]
        charge = getattr(self, "charge_tenant", None)
        if charge is not None and ctx is not None:
            for i in range(len(ready)):
                charge(ctx, float(dur[i, int(choice[i])]))
        for i, t in enumerate(ready):
            sim.push(t, int(choice[i]))
