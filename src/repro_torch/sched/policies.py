"""The score-matrix policies: ``random``, ``locality``, ``priority`` and
``wfq``, the counterparts of ``repro.sched.policies``.

  * ``random``: seeded uniform placement, the model-oblivious floor. It
    scores nothing and takes no device, as ``ws``;
  * ``locality``: greedy min-transfer placement (graph-partition style):
    each task goes to the resource minimizing predicted input-transfer
    time plus current backlog;
  * ``priority``: transfer + duration (HEFT's EFT without the backlog,
    which the load-aware driver adds); the tenant's submit-time priority
    divides the backlog it perceives;
  * ``wfq``: weighted-fair queueing over the same scores: each tenant's
    virtual time grows by duration / priority as its tasks are placed,
    and a tenant ahead of the least-served one yields.

``locality``, ``priority`` and ``wfq`` score each activation at least
``min_wide`` wide on ``device`` (default the card; raises without one)
through :meth:`TorchScoringBackend.score_matrices`: one copy in, one
``score_activation`` launch, one copy back, one sync. All three read the
transfer rows ``X``; ``priority`` and ``wfq`` add the class durations on
the host, as the reference does (``X + class_duration_matrix``). The
memory pressure is added on the host after that (by the driver, as the
reference adds it), never through ``x_bias``: the reference's order of
additions is ``(X + dur) + P``. Narrower activations take the host rows. The assignment stays the
reference's host loop (:func:`assign_from_scores`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.backend import TorchScoringBackend, check_min_wide
from ..core.dag import Task
from ..core.perfmodel import class_duration_matrix
from ..core.simulator import Simulator
from .policy import ScoreMatrixPolicy


class RandomPolicy(ScoreMatrixPolicy):
    """Uniform-random placement (seeded, deterministic): the baseline floor."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.name = f"random({seed})" if seed else "random"
        self._rng = np.random.default_rng(seed)

    def init(self, sim: Simulator) -> None:
        # reseeded per simulation: two runs with the same (sim seed,
        # policy seed) draw identical placement streams
        self._rng = np.random.default_rng(self.seed)

    def score_matrix(self, sim: Simulator, ready: Sequence[Task]) -> np.ndarray:
        return self._rng.random((len(ready), len(sim.machine.resources)))


class LocalityPolicy(ScoreMatrixPolicy):
    """Greedy min-transfer placement: score = predicted time to move the
    task's missing inputs to the resource's memory. The load-aware driver
    adds each resource's backlog, so ties on resident data spread across
    workers, and charges the chosen resource the predicted duration."""

    name = "locality"
    load_aware = True

    def __init__(self, device="cuda", min_wide: int = 1) -> None:
        """``device``: where each activation is scored (raises if it is
        ``cuda`` and no GPU is present). ``min_wide``: the narrowest
        activation scored on the device; narrower ones use the host rows."""
        self.backend = TorchScoringBackend(device)
        self.min_wide = check_min_wide(min_wide)

    def _host_rows(self, sim: Simulator, tids) -> np.ndarray:
        return np.asarray(
            sim.transfer_model.task_input_transfer_rows(
                sim.arrays, tids, [r.mem for r in sim.machine.resources], sim.residency
            ),
            dtype=np.float64,
        )

    def score_matrix(self, sim: Simulator, ready: Sequence[Task]) -> np.ndarray:
        tids = [t.tid for t in ready]
        if len(tids) < self.min_wide:
            return self._host_rows(sim, tids)
        return self.backend.score_matrices(
            sim, tids, sim.machine.resources, use_cp=True, x_rows=True
        )["X_np"]


class PriorityPolicy(LocalityPolicy):
    """Strict-weight tenant priority over earliest-finish placement.

    Score = predicted input-transfer time + class duration. The tenant's
    submit-time ``priority`` divides the backlog it perceives: a
    priority-2 tenant sees half the queue, so its tasks jump ahead of
    priority-1 work, while the shared time-stamps stay unscaled.
    Starvation is the policy's failure mode; :class:`WFQPolicy` fixes it.
    """

    name = "priority"

    def score_matrix(self, sim: Simulator, ready: Sequence[Task]) -> np.ndarray:
        return super().score_matrix(sim, ready) + class_duration_matrix(
            sim, [t.tid for t in ready]
        )

    def tenant_scale(self, sim, ctx) -> float:
        return 1.0 / max(float(ctx.priority), 1e-9)


class WFQPolicy(PriorityPolicy):
    """Weighted-fair queueing over the priority scores.

    Each tenant accumulates normalized service ``v[g] += duration /
    priority`` as its tasks are placed (``charge_tenant``); a new tenant
    starts at the pool minimum. The backlog a tenant perceives is scaled
    by how far ahead of the least-served tenant it is (clamped to [1, 8]),
    which bounds the worst tenant's slowdown. A serving engine retires a
    finished tenant (``retire_tenant``), so the minimum tracks the live
    tenants; the classic loop retires none, as the reference's does.
    """

    name = "wfq"
    _EPS = 1e-6

    def __init__(self, device="cuda", min_wide: int = 1) -> None:
        super().__init__(device=device, min_wide=min_wide)
        self._vt: dict = {}

    def init(self, sim: Simulator) -> None:
        # reset per simulation: two runs with the same seed accumulate
        # identical virtual times
        self._vt = {}

    def charge_tenant(self, ctx, dur: float) -> None:
        vt = self._vt
        gid = ctx.gid
        if gid not in vt:
            vt[gid] = min(vt.values()) if vt else 0.0
        vt[gid] += float(dur) / max(float(ctx.priority), 1e-9)

    def retire_tenant(self, ctx) -> None:
        # a finished tenant leaves the pool minimum (a long-done gid at a
        # low virtual time would hold every live tenant back)
        self._vt.pop(ctx.gid, None)

    def tenant_scale(self, sim, ctx) -> float:
        vt = self._vt
        v = vt.get(ctx.gid)
        if v is None:
            v = min(vt.values()) if vt else 0.0
            vt[ctx.gid] = v
        vmin = min(vt.values())
        eps = self._EPS
        scale = (eps + v) / (eps + vmin)
        return 1.0 if scale < 1.0 else (8.0 if scale > 8.0 else scale)
