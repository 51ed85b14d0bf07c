"""Bridge: the Policy score mechanism applied to LM-scale shard placement.

Counterpart of ``repro/dist/sched_bridge.py`` (numpy, the same function
line for line). The paper's scheduler decides task→resource placement
from (task × resource) score matrices (``repro_torch.sched``). The same
mechanism plans layout at the distribution layer:

  * **expert placement** (:func:`plan_expert_placement`) — MoE experts →
    device groups from per-expert routing mass, via the shared
    :func:`repro_torch.sched.assign_from_scores`: a (experts × groups)
    affinity score matrix (DADA's local-affinity phase: moving an expert
    away from where its weights already live costs ``α·mass``) plus
    load-aware greedy balance (the global phase) under an exact per-group
    capacity (``E / G`` experts each, so the dispatch buffer keeps a
    static shape). The result feeds
    :func:`repro_torch.models.moe.moe_apply`'s ``expert_perm``;
  * **layer partitioning** (:func:`partition_layers`) — pipeline stages by
    the classic dual approximation: binary search on the bottleneck guess
    λ, greedy maximal-prefix fill per probe (chains-on-chains, the same
    shape as DADA's λ search over task loads);
  * **all-to-all accounting** (:func:`expected_a2a_fraction`) — the
    fraction of routed tokens that cross group boundaries under a
    placement, i.e. the transfer volume a placement is scored on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..runtime.memory import predicted_eviction_bytes
from ..sched import assign_from_scores


@dataclass(frozen=True)
class ExpertPlacement:
    """Expert → device-group plan.

    ``assignment[e]`` is the group of expert ``e``; ``perm`` lists experts
    grouped by device (``perm[g*cap:(g+1)*cap]`` live on group ``g``) with
    ``inv_perm`` its inverse — the permutation ``moe_apply`` consumes.
    ``moved_experts`` counts differences against the previous assignment
    (0 when none was given).
    """

    assignment: np.ndarray
    group_load: np.ndarray
    perm: np.ndarray
    inv_perm: np.ndarray
    moved_experts: int


def plan_expert_placement(
    routing_mass: Sequence[float],
    n_groups: int,
    prev_assignment: Optional[Sequence[int]] = None,
    alpha: float = 1.0,
    expert_bytes: Optional[float] = None,
    group_hbm_bytes: Optional[float] = None,
    group_resident_bytes: Optional[Sequence[float]] = None,
    mem_penalty: float = 1.0,
) -> ExpertPlacement:
    """Place experts on device groups from routing statistics.

    ``routing_mass[e]`` is the observed token mass routed to expert ``e``.
    Experts are placed heaviest-first (LPT) onto the group minimizing
    ``affinity_score + current_load`` with exactly ``E / G`` slots per
    group; with a ``prev_assignment`` the affinity score makes staying
    free and moving cost ``alpha * mass`` — DADA's affinity phase, so
    mildly-changed loads keep most experts where their weights already
    are. ``alpha = 0`` ignores history entirely.

    With ``expert_bytes`` and ``group_hbm_bytes`` the replan also prices
    memory pressure with the simulator's eviction-cost formula
    (:func:`repro_torch.runtime.memory.predicted_eviction_bytes`): *moving* an
    expert to group ``g`` forces ``predicted_eviction_bytes(resident_g,
    expert_bytes, group_hbm_bytes)`` bytes of weights/activations out of
    that group's HBM; staying put costs nothing. ``group_resident_bytes``
    (default: experts currently assigned × ``expert_bytes``) is each
    group's occupancy and ``mem_penalty`` scales evicted bytes into the
    score's mass units.
    """
    mass = np.asarray(routing_mass, dtype=np.float64)
    E = len(mass)
    if E == 0 or n_groups <= 0 or E % n_groups != 0:
        raise ValueError(
            f"need experts divisible by groups, got E={E}, G={n_groups}"
        )
    cap = E // n_groups

    # affinity scores: staying put is free, moving costs alpha * mass
    scores = np.zeros((E, n_groups), dtype=np.float64)
    prev = None
    if prev_assignment is not None and alpha > 0.0:
        prev = np.asarray(prev_assignment, dtype=np.int64)
        if len(prev) != E:
            raise ValueError("prev_assignment length != number of experts")
        move_cost = alpha * mass
        scores += move_cost[:, None]
        valid = (prev >= 0) & (prev < n_groups)
        scores[np.nonzero(valid)[0], prev[valid]] = 0.0

    if expert_bytes is not None and group_hbm_bytes is not None:
        if group_resident_bytes is not None:
            resident = np.asarray(group_resident_bytes, dtype=np.float64)
            if len(resident) != n_groups:
                raise ValueError("group_resident_bytes length != n_groups")
        elif prev is not None:
            valid = (prev >= 0) & (prev < n_groups)
            resident = np.bincount(
                prev[valid], minlength=n_groups
            ).astype(np.float64) * float(expert_bytes)
        else:
            resident = np.zeros(n_groups, dtype=np.float64)
        # the same eviction cost the scheduler's pressure signal charges:
        # bytes this expert's weights would push out of the target HBM
        evict = predicted_eviction_bytes(
            resident, float(expert_bytes), float(group_hbm_bytes)
        )
        pressure = np.broadcast_to(
            mem_penalty * evict[None, :], (E, n_groups)
        ).copy()
        if prev is not None:
            valid = (prev >= 0) & (prev < n_groups)
            pressure[np.nonzero(valid)[0], prev[valid]] = 0.0  # staying is free
        scores += pressure

    # heaviest-first (stable on ties) through the shared placement kernel
    order = np.lexsort((np.arange(E), -mass))
    choice, loads = assign_from_scores(
        scores,
        loads=np.zeros(n_groups),
        costs=np.broadcast_to(mass[:, None], (E, n_groups)),
        capacity=np.full(n_groups, cap, dtype=np.int64),
        order=order,
        return_loads=True,
    )
    assignment = np.asarray(choice, dtype=np.int64)
    # loads include the affinity zeros only through costs=mass: recompute
    # the true per-group mass for reporting
    group_load = np.bincount(assignment, weights=mass, minlength=n_groups)
    perm = np.argsort(assignment, kind="stable")
    inv_perm = np.argsort(perm, kind="stable")
    moved = int((assignment != prev).sum()) if prev is not None else 0
    return ExpertPlacement(
        assignment=assignment,
        group_load=group_load,
        perm=perm,
        inv_perm=inv_perm,
        moved_experts=moved,
    )


def expected_a2a_fraction(
    mass_by_source: np.ndarray, assignment: Sequence[int]
) -> float:
    """Fraction of routed token mass that crosses device groups.

    ``mass_by_source[g, e]``: mass routed from tokens resident on group
    ``g`` to expert ``e``. Mass staying on its own group skips the
    all-to-all; everything else pays it.
    """
    m = np.asarray(mass_by_source, dtype=np.float64)
    a = np.asarray(assignment, dtype=np.int64)
    G, E = m.shape
    total = m.sum()
    if total <= 0:
        return 0.0
    local = sum(float(m[g, a == g].sum()) for g in range(G))
    return float(1.0 - local / total)


# ---------------------------------------------------------------------------
# pipeline-stage partitioning (chains-on-chains dual approximation)


def stage_loads(costs: Sequence[float], starts: Sequence[int]) -> List[float]:
    """Per-stage cost sums for stage boundaries ``starts`` (first must be
    0; stage ``i`` spans ``starts[i]:starts[i+1]``)."""
    bounds = list(starts) + [len(costs)]
    return [float(sum(costs[a:b])) for a, b in zip(bounds, bounds[1:])]


def _greedy_starts(costs: Sequence[float], lam: float) -> List[int]:
    """Maximal-prefix fill: new stage exactly when adding the next layer
    would overreach λ (greedy is stage-minimal among ≤λ partitions)."""
    starts = [0]
    acc = 0.0
    for i, c in enumerate(costs):
        if acc + c > lam and acc > 0.0:
            starts.append(i)
            acc = 0.0
        acc += c
    return starts


def partition_layers(costs: Sequence[float], k: int) -> List[int]:
    """Split a layer chain into ``k`` pipeline stages (dual approximation).

    Binary search on the bottleneck guess λ within
    ``[max(max_cost, total/k), total]``; each probe greedily fills stages
    up to λ and is feasible iff it needs ≤ k stages. The accepted
    partition satisfies the classic bound
    ``max(stage) ≤ 2 * max(max_cost, total/k)``. Returns exactly ``k``
    stage starts (surplus stages are empty tail stages on short chains).
    """
    costs = [float(c) for c in costs]
    if k <= 0:
        raise ValueError("need at least one stage")
    total = sum(costs)
    lo = max(max(costs, default=0.0), total / k)
    hi = total
    if not costs or lo <= 0.0:
        return [0] + [len(costs)] * (k - 1)
    best = _greedy_starts(costs, lo)
    if len(best) > k:  # lo infeasible: bisect up to the minimal feasible λ
        best = _greedy_starts(costs, hi)
        for _ in range(100):
            if hi - lo <= 1e-12 * hi:
                break
            mid = (lo + hi) / 2.0
            s = _greedy_starts(costs, mid)
            if len(s) <= k:
                hi = mid
                best = s
            else:
                lo = mid
    starts = best + [len(costs)] * (k - len(best))
    return starts[:k]
