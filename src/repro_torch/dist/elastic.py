"""Elastic re-planning: device loss/gain → mesh shape + expert placement.

Counterpart of ``repro/dist/elastic.py`` (numpy, the same function).

A pod that loses devices (preemption, hardware fault) must keep serving:
``choose_mesh_shape`` picks the largest supported (data, model) mesh that
fits the surviving device count, and ``replan`` rebuilds the expert
placement *with affinity to the previous plan* — the paper's criterion
applied to failure recovery: experts whose weights already live on
surviving groups stay put, so the re-shard moves a minimum of bytes.

:class:`ElasticReplanner` closes the loop with the fault-injected
runtime (``repro_torch.runtime.faults``): it subscribes to an engine's
detach/attach notifications and re-plans on every membership change,
carrying the previous assignment forward so each recovery step is
affinity-minimal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .sched_bridge import ExpertPlacement, plan_expert_placement

MODEL_AXIS = 16  # the TP group: fixed by kernel tiling, never degraded


def choose_mesh_shape(n_devices: int, model_axis: int = MODEL_AXIS) -> Tuple[int, int]:
    """Largest (data, model) mesh fitting ``n_devices``.

    The model axis stays fixed (TP layouts are compiled for it; default
    16); the data axis degrades to the largest power of two that fits,
    so a 300-device degraded pod runs as (16, 16) and a 17-device
    remnant as (1, 16).
    """
    if model_axis < 1:
        raise ValueError(f"model_axis must be >= 1, got {model_axis}")
    if n_devices < model_axis:
        raise ValueError(
            f"need at least {model_axis} devices for one TP group, "
            f"got {n_devices}"
        )
    data = 1
    while data * 2 * model_axis <= n_devices:
        data *= 2
    return (data, model_axis)


@dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, int]
    n_devices: int  # devices actually used
    placement: ExpertPlacement


def replan(
    n_devices: int,
    *,
    n_experts: int,
    routing_mass: Optional[Sequence[float]] = None,
    prev_assignment: Optional[Sequence[int]] = None,
    alpha: float = 1.0,
    model_axis: int = MODEL_AXIS,
) -> ElasticPlan:
    """Re-plan mesh + expert placement after a device-count change.

    Expert groups ride the model axis (the all-to-all stays inside a
    pod's fast interconnect); when the expert count does not divide the
    axis, the group count halves until it does. ``prev_assignment``
    (from the plan being replaced) engages the affinity phase so
    surviving experts keep their weights in place.
    """
    shape = choose_mesh_shape(n_devices, model_axis)
    groups = shape[1]
    while groups > 1 and n_experts % groups:
        groups //= 2
    if routing_mass is None:
        mass = np.ones(n_experts, dtype=np.float64)  # no stats yet: uniform
    else:
        mass = np.asarray(routing_mass, dtype=np.float64)
    if len(mass) != n_experts:
        raise ValueError("routing_mass length != n_experts")
    prev = prev_assignment
    if prev is not None:
        prev = np.asarray(prev, dtype=np.int64)
        # groups that no longer exist carry no affinity
        prev = np.where(prev < groups, prev, -1)
    placement = plan_expert_placement(mass, groups, prev_assignment=prev, alpha=alpha)
    return ElasticPlan(
        mesh_shape=shape,
        n_devices=shape[0] * shape[1],
        placement=placement,
    )


def moved_experts(
    prev: Optional[ElasticPlan], new: Optional[ElasticPlan]
) -> int:
    """Experts whose group changed between two plans (weight moves).

    Experts mapped to groups that no longer exist count as moved; with
    either plan missing every expert of the other plan moves.
    """
    if new is None:
        return 0 if prev is None else len(prev.placement.assignment)
    if prev is None:
        return len(new.placement.assignment)
    a = np.asarray(prev.placement.assignment, dtype=np.int64)
    b = np.asarray(new.placement.assignment, dtype=np.int64)
    if a.shape != b.shape:
        raise ValueError("plans place different expert counts")
    return int(np.count_nonzero(a != b))


class ElasticReplanner:
    """Live elastic re-planning driven by the fault-injected runtime.

    Subscribes to an engine's :class:`~repro_torch.runtime.faults.FaultManager`
    and re-plans the mesh + expert placement on every accelerator
    detach/attach, mapping each surviving accelerator to
    ``devices_per_worker`` pod devices. Every step passes the previous
    assignment through, so the affinity phase keeps surviving experts'
    weights in place and ``total_moved`` measures exactly the re-shard
    traffic the paper's criterion saves.

    When the surviving device count drops below one TP group the pod
    cannot serve; the event is still recorded (with plan ``None``) and
    ``current`` keeps the last viable plan so a later attach resumes
    with affinity to it.
    """

    def __init__(
        self,
        *,
        devices_per_worker: int,
        n_experts: int,
        model_axis: int = MODEL_AXIS,
        routing_mass: Optional[Sequence[float]] = None,
        alpha: float = 1.0,
    ) -> None:
        if devices_per_worker < 1:
            raise ValueError("devices_per_worker must be >= 1")
        self.devices_per_worker = devices_per_worker
        self.n_experts = n_experts
        self.model_axis = model_axis
        self.routing_mass = routing_mass
        self.alpha = alpha
        self.current: Optional[ElasticPlan] = None
        #: (time, event, n_devices, plan-or-None) per membership change
        self.history: List[Tuple[float, str, int, Optional[ElasticPlan]]] = []
        self.total_moved = 0

    # ------------------------------------------------------------------
    def attach_to(self, engine) -> "ElasticReplanner":
        """Wire to a live engine: plan for the current membership, then
        follow every detach/attach through ``engine.faults``."""
        engine.faults.subscribe(self._on_fault)
        self._replan(engine, float(engine.now), "init")
        return self

    def _on_fault(self, engine, event: str, rid: int, mode) -> None:
        if event in ("detach", "attach"):
            self._replan(engine, float(engine.now), event)

    # ------------------------------------------------------------------
    def _alive_accels(self, engine) -> int:
        dead = engine.faults.dead_rids
        return sum(1 for r in engine.machine.gpus if r.rid not in dead)

    def _replan(self, engine, t: float, event: str) -> None:
        n_devices = self._alive_accels(engine) * self.devices_per_worker
        if n_devices >= self.model_axis:
            prev = (
                None
                if self.current is None
                else self.current.placement.assignment
            )
            plan = replan(
                n_devices,
                n_experts=self.n_experts,
                routing_mass=self.routing_mass,
                prev_assignment=prev,
                alpha=self.alpha,
                model_axis=self.model_axis,
            )
            if self.current is not None:
                self.total_moved += moved_experts(self.current, plan)
            self.current = plan
        else:
            plan = None  # below one TP group: keep last viable plan
        self.history.append((t, event, n_devices, plan))
