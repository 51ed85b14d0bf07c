"""DADA — Distributed Affinity Dual Approximation (paper §3.2, Algorithm 2).

Binary search on a makespan guess ``λ``; for each guess:

  * **local affinity phase** — ready tasks are placed on their max-affinity
    processor (affinity = bytes the task writes that are resident there),
    loading each processor up to *overreaching* ``α·λ``;
  * **global balance phase** — a ρ=2 dual approximation on the rest: tasks
    that only fit one class are dedicated; flexible tasks go to GPUs by
    decreasing speedup until the GPU loads overreach ``λ``; the remainder
    goes to CPUs with an earliest-finish-time rule;
  * the guess is accepted iff every processor's load fits ``(2+α)·λ``.

``α = 0`` disables the affinity phase: DADA(0) is the plain dual
approximation. ``use_cp=True`` (the paper's "+CP") adds communication
prediction (asymptotic-bandwidth model) to every load/finish-time estimate.

Counterpart of ``repro.core.dada``. The host computes what is
λ-independent and cheap (the class durations, the backlogs, the flexible
order and the sums); for activations at least ``min_wide`` wide (default
1: every activation) the device backend then scores the activation and
runs the whole λ search on the card, right after the scorer, and returns
the placement alone (:meth:`TorchScoringBackend.place_dada`). Narrower
activations take the host rows and the kernel's plain version. Either
way the preferences, the bisection and ``try_build`` follow the
reference's order, so decisions (including tie-breaks) are bit-identical
to ``repro``'s.

Under +CP and a memory capacity the predicted eviction seconds
(:func:`repro_torch.runtime.memory.pressure_rows_for`, without its fault
columns) are folded into the transfer rows before the cost matrix, as the
reference folds them: through the scorer's ``x_bias`` section on the
device, through ``fold_pressure`` on the host.

On a machine that loses resources (:mod:`repro_torch.runtime.faults`) the
placement takes their liveness, as the reference's scalar path does: a
detached resource is out of the CPU and GPU pools, its backlog counts 0,
the preference scan skips it and the area bound counts only the alive
resources. With ``recover=True`` (``resolve("dada?recover=1")``) a
noticed resource (a detach announced, not yet fired) is skipped by the
preference scan too and its column of the cost matrix pays the remaining
notice window, so new work steers off a condemned device before it dies;
with no notice pending, ``recover`` changes nothing. These inputs travel
in the placement section (:func:`~repro_torch.kernels.sched_place.pack_dada`),
so every activation at least ``min_wide`` wide is still placed on the
card, dead resources or not.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..kernels.sched_place import STATUS_OK, dada_place_plain
from ..runtime.memory import fold_pressure, pressure_rows_for
from .affinity import AFFINITIES, affinity_rows
from .backend import TorchScoringBackend, check_min_wide
from .dag import Task
from .simulator import Simulator, Strategy

_TINY = 1e-12  # the speedup keys' floor
_WIDE = 32  # ready-set size from which the batched numpy paths win


class DADA(Strategy):

    def __init__(
        self,
        alpha: float = 0.5,
        use_cp: bool = False,
        affinity: str = "accel_write",
        eps_rel: float = 0.01,
        max_iters: int = 30,
        area_bound: bool = False,
        recover: bool = False,
        device="cuda",
        min_wide: int = 1,
    ) -> None:
        """``area_bound``: also reject a guess λ when the total work area
        exceeds λ x (number of resources) — a valid no-schedule
        certificate. Off by default (the paper's Algorithm 2 rejects only
        on the big-task criterion).

        ``recover``: notice-aware placement. A noticed resource's cost
        column pays the remaining notice window and the affinity phase
        skips it. Off by default; outside notice windows it changes
        nothing.

        ``affinity``: the score of the affinity phase (one of
        :data:`~repro_torch.core.affinity.AFFINITIES`). Under
        ``"missing_bytes"`` every score is at most 0 and the phase wants
        one above 0, so no task is placed by affinity; S is still computed
        (on the card by the scorer's ``s_missing`` flag) and the runs equal
        the reference's.

        ``device``: where each activation is scored and placed (raises if
        it is ``cuda`` and no GPU is present). ``min_wide``: the narrowest
        activation scored and placed on the device; narrower ones use the
        host rows and the plain λ search.
        """
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be within [0, 1]")
        if affinity not in AFFINITIES:
            raise ValueError(f"unknown affinity {affinity!r} (choose from {AFFINITIES})")
        self.alpha = alpha
        self.use_cp = use_cp
        self.affinity_name = affinity
        self.eps_rel = eps_rel
        self.max_iters = max_iters
        self.area_bound = area_bound
        self.recover = recover
        self.backend = TorchScoringBackend(device)
        self.min_wide = check_min_wide(min_wide)
        cp = "+cp" if use_cp else ""
        rec = "+rec" if recover else ""
        self.name = f"dada({alpha:g}){cp}{rec}"

    # ------------------------------------------------------------------
    def preamble(self, sim: Simulator, tids: List[int]):
        """The λ-independent host values of one activation: ``(p_cpu,
        p_gpu, section)``, the class durations and the rest of the
        placement section (backlogs, the flexible order, the sums, α, the
        search's limits, the alive CPU and GPU rids and, when a resource
        is detached or, under ``recover``, noticed, the liveness inputs)."""
        resources = sim.machine.resources
        cpus, gpus = sim.machine.cpus, sim.machine.gpus
        cpu_cls = cpus[0].cls if cpus else gpus[0].cls
        gpu_cls = gpus[0].cls if gpus else cpu_cls
        n = len(tids)
        if n >= _WIDE:
            tids_arr = np.asarray(tids, dtype=np.int64)
            p_cpu = sim.predictor(cpu_cls).times(tids_arr).tolist()
            p_gpu = sim.predictor(gpu_cls).times(tids_arr).tolist()
        else:
            p_cpu = sim.predictor(cpu_cls).times_list(tids)
            p_gpu = sim.predictor(gpu_cls).times_list(tids)

        # detached resources, and the notice penalties by resource position
        # under recover: the remaining window where it is still positive
        faults = getattr(sim, "faults", None)
        dead = faults.dead_rids if faults is not None and faults.any_dead else frozenset()
        pen = {}
        if self.recover and faults is not None and faults.noticed:
            for j, r in enumerate(resources):
                pending = faults.noticed.get(r.rid)
                if pending is not None and pending[1] - sim.now > 0.0:
                    pen[j] = pending[1] - sim.now
        offsets = [
            lt - sim.now if lt - sim.now > 0.0 else 0.0
            for lt in (sim.load_ts[r.rid] for r in resources)
        ]
        if dead:
            # a dead resource receives no load and carries no backlog
            for j, r in enumerate(resources):
                if r.rid in dead:
                    offsets[j] = 0.0
        # speedup sort keys for the flexible phase (λ-independent); per-probe
        # flex sets are subsets of ready, so filtering this order equals
        # sorting each subset
        skey = [-(pc / max(pg, _TINY)) for pc, pg in zip(p_cpu, p_gpu)]
        if n >= _WIDE:
            flex_order = np.lexsort(
                (np.asarray(tids, dtype=np.int64), np.asarray(skey))
            ).tolist()
        else:
            flex_order = sorted(range(n), key=lambda i: (skey[i], tids[i]))
        cpu_rids = [r.rid for r in cpus if r.rid not in dead]
        gpu_rids = [r.rid for r in gpus if r.rid not in dead]
        if not (cpu_rids or gpu_rids):
            raise RuntimeError("DADA: every resource is detached")
        section = dict(
            offsets=offsets, flex_order=flex_order,
            max_off=max(offsets, default=0.0),
            sum_max=sum(max(pc, pg) for pc, pg in zip(p_cpu, p_gpu)),
            area=sum(min(pc, pg) for pc, pg in zip(p_cpu, p_gpu)) if self.area_bound else 0.0,
            off_total=sum(offsets) if self.area_bound else 0.0,
            alpha=self.alpha, eps_rel=self.eps_rel, max_iters=self.max_iters,
            cpu_rids=cpu_rids, gpu_rids=gpu_rids,
        )
        if dead or pen:
            section.update(
                pen=[pen.get(j, 0.0) for j in range(len(resources))],
                skip=[r.rid in dead or j in pen for j, r in enumerate(resources)],
                n_alive=len(resources) - len(dead),
                pen_top=n * max(pen.values()) if pen else 0.0,
            )
        return p_cpu, p_gpu, section

    def place(self, sim: Simulator, ready: List[Task], src: Optional[int]) -> None:
        resources = sim.machine.resources
        n_res = len(resources)
        n = len(ready)
        tids = [t.tid for t in ready]
        p_cpu, p_gpu, section = self.preamble(sim, tids)
        affinity = self.affinity_name if self.alpha > 0.0 else None
        # memory-pressure penalty under +CP (None unless the memories are
        # bounded); without the fault columns: the dead and noticed
        # resources are inputs of the placement (an +inf row maximum would
        # blow up the search's upper bound)
        P = pressure_rows_for(sim, tids, resources, fault_mask=False) if self.use_cp else None

        if n >= self.min_wide:
            # scored and placed on the device, dead resources or not; only
            # the placement comes back
            placed = self.backend.place_dada(
                sim, tids, resources, p_cpu=p_cpu, p_gpu=p_gpu, use_cp=self.use_cp,
                affinity=affinity, area_bound=self.area_bound, x_bias=P, **section,
            )
        else:
            X = (
                fold_pressure(
                    sim.transfer_model.task_input_transfer_rows(
                        sim.arrays, tids, [r.mem for r in resources], sim.residency
                    ),
                    P,
                )
                if self.use_cp
                else None
            )
            # cost matrix C[i][rid] = duration-on-class + predicted transfer
            gpu_pos = [j for j, r in enumerate(resources) if r.is_accelerator]
            C_rows = []
            if X is None:
                for pc, pg in zip(p_cpu, p_gpu):
                    row = [pc] * n_res
                    for j in gpu_pos:
                        row[j] = pg
                    C_rows.append(row)
            else:
                for pc, pg, xrow in zip(p_cpu, p_gpu, X):
                    row = [pc + x for x in xrow]
                    for j in gpu_pos:
                        row[j] = pg + xrow[j]
                    C_rows.append(row)
            S = (
                affinity_rows(affinity, sim.arrays, tids, resources, sim.residency)
                if affinity is not None
                else None
            )
            placed = dada_place_plain(
                C=C_rows, S=S, x_max=None if X is None else [max(xrow) for xrow in X],
                p_cpu=p_cpu, p_gpu=p_gpu, tids=tids, area_bound=self.area_bound, **section,
            )
        if placed.status != STATUS_OK:
            raise RuntimeError("DADA: λ=upper must always be feasible")

        # expose the accepted guess for tests / introspection
        self.last_lambda = placed.lam
        self.last_loads = {r.rid: placed.loads[j] for j, r in enumerate(resources)}
        for t, rid in zip(ready, placed.rids):
            sim.push(t, rid)
        for j, r in enumerate(resources):
            sim.load_ts[r.rid] = sim.now + placed.loads[j]

    def score_matrix(self, sim: Simulator, ready: List[Task]) -> np.ndarray:
        """DADA's λ-independent cost matrix, (ready × resources): the class
        duration (+ the predicted transfer and the memory pressure under
        +CP), the rows every probe of the search folds. An introspection
        view on the host; ``place`` stays authoritative."""
        tids = [t.tid for t in ready]
        resources = sim.machine.resources
        cpus, gpus = sim.machine.cpus, sim.machine.gpus
        cpu_cls = cpus[0].cls if cpus else gpus[0].cls
        gpu_cls = gpus[0].cls if gpus else cpu_cls
        p_cpu = sim.predictor(cpu_cls).times_list(tids)
        p_gpu = sim.predictor(gpu_cls).times_list(tids)
        accel = np.array([r.is_accelerator for r in resources])
        C = np.where(accel[None, :], np.asarray(p_gpu)[:, None], np.asarray(p_cpu)[:, None])
        if self.use_cp:
            X = np.asarray(
                sim.transfer_model.task_input_transfer_rows(
                    sim.arrays, tids, [r.mem for r in resources], sim.residency
                )
            )
            P = pressure_rows_for(sim, tids, resources)
            if P is not None:
                X = X + P
            C = C + X
        return C


class DualApprox(DADA):
    """Plain ρ=2 dual approximation — DADA with the affinity phase off."""

    def __init__(self, use_cp: bool = False, **kw) -> None:
        super().__init__(alpha=0.0, use_cp=use_cp, **kw)
        self.name = "dual" + ("+cp" if use_cp else "")
