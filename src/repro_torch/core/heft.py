"""HEFT — Heterogeneous Earliest Finish Time, XKaapi variant (paper §3.1).

Both phases run inside ``activate`` (Algorithm 1):
  * task prioritizing: ready tasks sorted by decreasing GPU speedup
    ``S_i = p_i^CPU / p_i^GPU`` (the paper replaces upward-rank with this),
  * worker selection: each task goes to the worker with the earliest
    predicted finish time, *always* including predicted transfer time.

Counterpart of ``repro.core.heft``. For activations at least
``min_wide`` wide (default 1: every activation) the device backend
computes the (ready × resources) transfer matrix and runs the EFT scan on
the card right after it, returning only each task's rid and finish time
(:meth:`TorchScoringBackend.place_heft`); narrower activations take the
host rows and the scan's plain version. The scan keeps the reference's
strict-improvement rule (ties within 1e-15 keep the lower rid), so
placements are bit-identical to ``repro``'s.

Under a memory capacity the predicted eviction seconds
(:func:`repro_torch.runtime.memory.pressure_rows_for`) are folded into the
transfer rows, as the reference folds them: through the scorer's
``x_bias`` section on the device, through ``fold_pressure`` on the host.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..kernels.sched_place import heft_select_plain
from ..runtime.memory import fold_pressure, pressure_rows_for
from .backend import TorchScoringBackend, check_min_wide
from .dag import Task
from .perfmodel import class_duration_matrix
from .simulator import Simulator, Strategy

_WIDE = 32  # ready-set size from which the batched numpy predictions win


class HEFT(Strategy):
    name = "heft"

    def __init__(self, device="cuda", min_wide: int = 1) -> None:
        """``device``: where each activation is scored and placed (raises
        if it is ``cuda`` and no GPU is present). ``min_wide``: the
        narrowest activation scored and placed on the device; narrower
        ones use the host rows and the scan's plain version."""
        self.backend = TorchScoringBackend(device)
        self.min_wide = check_min_wide(min_wide)

    def preamble(self, sim: Simulator, tids: List[int]) -> dict:
        """The EFT scan's host values of one activation: the priority
        ``order``, the class ``durations``, each resource's class
        (``cls_of_res``), ``load_ts`` and ``now``."""
        machine = sim.machine
        cpus, gpus = machine.cpus, machine.gpus
        cpu_cls = cpus[0].cls if cpus else gpus[0].cls
        gpu_cls = gpus[0].cls if gpus else cpu_cls
        n = len(tids)

        # --- per-class predicted durations (activation-invariant) --------
        if n >= _WIDE:
            tids_arr = np.asarray(tids, dtype=np.int64)
            p_cpu = sim.predictor(cpu_cls).times(tids_arr).tolist()
            p_gpu = sim.predictor(gpu_cls).times(tids_arr).tolist()
        else:
            p_cpu = sim.predictor(cpu_cls).times_list(tids)
            p_gpu = sim.predictor(gpu_cls).times_list(tids)

        # --- task prioritizing: decreasing speedup -----------------------
        speed = [pc / pg if pg > 0 else 1.0 for pc, pg in zip(p_cpu, p_gpu)]
        order = sorted(range(n), key=lambda i: (-speed[i], tids[i]))

        # the duration classes and each resource's class
        cls_times = {cpu_cls.name: p_cpu, gpu_cls.name: p_gpu}
        for r in machine.resources:
            if r.cls.name not in cls_times:
                cls_times[r.cls.name] = sim.predictor(r.cls).times_list(tids)
        cls_index = {name: k for k, name in enumerate(cls_times)}
        return dict(
            order=order, durations=list(cls_times.values()),
            cls_of_res=[cls_index[r.cls.name] for r in machine.resources],
            load_ts=sim.load_ts, now=sim.now,
        )

    def place(self, sim: Simulator, ready: List[Task], src: Optional[int]) -> None:
        resources = sim.machine.resources
        n = len(ready)
        tids = [t.tid for t in ready]
        scan = self.preamble(sim, tids)
        # memory-pressure penalty (None unless the memories are bounded)
        P = pressure_rows_for(sim, tids, resources)

        # --- worker selection: earliest finish time ----------------------
        if n >= self.min_wide:
            # scored and scanned on the device; only the placement comes back
            placed = self.backend.place_heft(sim, tids, resources, x_bias=P, **scan)
        else:
            X = fold_pressure(
                sim.transfer_model.task_input_transfer_rows(
                    sim.arrays, tids, [r.mem for r in resources], sim.residency
                ),
                P,
            )
            placed = heft_select_plain(X=X, **scan)
        load_ts = sim.load_ts
        for i, rid, eft in zip(scan["order"], placed.rids, placed.efts):
            load_ts[rid] = eft
            sim.push(ready[i], rid)

    def score_matrix(self, sim: Simulator, ready: List[Task]) -> np.ndarray:
        """Earliest-finish-time scores, (ready × resources): start +
        transfer (+ the memory pressure, as ``place`` folds it) +
        duration. An introspection view on the host; ``place`` stays
        authoritative."""
        tids = [t.tid for t in ready]
        resources = sim.machine.resources
        X = np.asarray(
            sim.transfer_model.task_input_transfer_rows(
                sim.arrays, tids, [r.mem for r in resources], sim.residency
            )
        )
        P = pressure_rows_for(sim, tids, resources)
        if P is not None:
            X = X + P
        dur = class_duration_matrix(sim, tids)
        start = np.array([lt if lt > sim.now else sim.now for lt in sim.load_ts])
        return start[None, :] + X + dur
