"""Straggler mitigation: history-calibrated micro-batch re-balancing.

Counterpart of ``repro/dist/straggler.py`` (numpy, the same function).

The paper's history-based performance model (§2.3) at the data-parallel
level: shards report observed step times, the planner learns per-shard
per-microbatch cost and re-apportions the fixed global micro-batch budget
inversely to it — a persistent straggler sheds work instead of stalling
every all-reduce. This is the same earliest-finish-time load balancing the
scheduling core applies to tasks, with micro-batches as the unit of work.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class StragglerPlanner:
    """Plans per-shard micro-batch counts from observed step times.

    ``plan()`` returns an integer allocation summing to
    ``total_microbatches``; before any observation it is uniform. Each
    ``observe(times, plan)`` updates the per-shard per-microbatch cost
    estimate (exponential moving average, ``ema`` weight on the new
    sample), and subsequent plans allocate proportionally to shard speed
    (largest-remainder rounding keeps the total exact).

    Shards lost to preemption are taken out of rotation with
    :meth:`deactivate` (their allocation drops to zero and their cost
    estimate freezes) and rejoin with :meth:`reactivate`, resuming from
    the frozen estimate — the planner-level mirror of the runtime's
    detach/attach (``repro_torch.runtime.faults``).
    """

    def __init__(
        self,
        n_shards: int,
        total_microbatches: int,
        ema: float = 1.0,
    ) -> None:
        if n_shards <= 0 or total_microbatches < n_shards:
            raise ValueError(
                "need at least one micro-batch per shard "
                f"(shards={n_shards}, total={total_microbatches})"
            )
        self.n_shards = n_shards
        self.total = total_microbatches
        self.ema = ema
        # relative per-microbatch cost per shard; uniform until observed
        self._cost = np.ones(n_shards, dtype=np.float64)
        self._active = np.ones(n_shards, dtype=bool)
        self.n_observations = 0

    # ------------------------------------------------------------------
    def _check_shard(self, i: int) -> int:
        i = int(i)
        if not 0 <= i < self.n_shards:
            raise ValueError(f"shard {i} out of range [0, {self.n_shards})")
        return i

    def deactivate(self, i: int) -> None:
        """Take shard ``i`` out of rotation (idempotent). Its cost
        estimate freezes at the last observed value."""
        i = self._check_shard(i)
        self._active[i] = False
        if not self._active.any():
            self._active[i] = True
            raise ValueError("cannot deactivate the last active shard")

    def reactivate(self, i: int) -> None:
        """Return shard ``i`` to rotation (idempotent), resuming from
        its frozen cost estimate."""
        self._active[self._check_shard(i)] = True

    @property
    def active(self) -> np.ndarray:
        """Boolean active mask (copy)."""
        return self._active.copy()

    @property
    def n_active(self) -> int:
        return int(np.count_nonzero(self._active))

    # ------------------------------------------------------------------
    def observe(
        self, times: Sequence[float], plan: Sequence[int]
    ) -> None:
        """Record one step: ``times[i]`` seconds for ``plan[i]`` micro-batches."""
        times = np.asarray(times, dtype=np.float64)
        plan = np.asarray(plan, dtype=np.float64)
        if times.shape != (self.n_shards,) or plan.shape != (self.n_shards,):
            raise ValueError("times/plan must have one entry per shard")
        ran = plan > 0
        sample = np.where(ran, times / np.where(ran, plan, 1.0), self._cost)
        self._cost = (1.0 - self.ema) * self._cost + self.ema * sample
        self.n_observations += 1

    # ------------------------------------------------------------------
    def plan(self) -> np.ndarray:
        """Integer micro-batch allocation ∝ shard speed, summing exactly.

        Only active shards receive work (inactive allocations are 0);
        the total must still cover one micro-batch per active shard.
        """
        act = np.flatnonzero(self._active)
        if self.total < act.size:
            raise ValueError(
                "need at least one micro-batch per active shard "
                f"(active={act.size}, total={self.total})"
            )
        speed = 1.0 / np.maximum(self._cost[act], 1e-12)
        raw = self.total * speed / speed.sum()
        base = np.floor(raw).astype(np.int64)
        # every shard keeps at least one micro-batch: a starved shard
        # would never report a fresh time and could stay mis-calibrated
        base = np.maximum(base, 1)
        surplus = int(base.sum()) - self.total
        if surplus > 0:
            # take back from the slowest shards' rounded-up minimums
            for i in np.argsort(raw):
                while surplus > 0 and base[i] > 1:
                    take = min(surplus, int(base[i] - 1))
                    base[i] -= take
                    surplus -= take
                if surplus == 0:
                    break
        elif surplus < 0:
            frac = raw - np.floor(raw)
            for i in np.argsort(-frac, kind="stable"):
                base[i] += 1
                surplus += 1
                if surplus == 0:
                    break
            while surplus < 0:  # more remainder than shards: round-robin
                for i in np.argsort(-frac, kind="stable"):
                    base[i] += 1
                    surplus += 1
                    if surplus == 0:
                        break
        out = np.zeros(self.n_shards, dtype=np.int64)
        out[act] = base
        return out

    # ------------------------------------------------------------------
    def expected_makespan(self, plan: Sequence[int]) -> float:
        """Predicted step time: the slowest shard under ``plan``."""
        plan = np.asarray(plan, dtype=np.float64)
        return float(np.max(plan * self._cost))
