"""HEFT — Heterogeneous Earliest Finish Time, XKaapi variant (paper §3.1).

Both phases run inside ``activate`` (Algorithm 1):
  * task prioritizing: ready tasks sorted by decreasing GPU speedup
    ``S_i = p_i^CPU / p_i^GPU`` (the paper replaces upward-rank with this),
  * worker selection: each task goes to the worker with the earliest
    predicted finish time, *always* including predicted transfer time.

Counterpart of ``repro.core.heft``. The (ready × resources) transfer
matrix comes from the device backend for activations at least
``min_wide`` wide (default 1: every activation) and from the host rows
otherwise; the EFT scan then runs on the host over those rows with the
reference's strict-improvement rule (ties within 1e-15 keep the lower
rid), so placements are bit-identical to ``repro``'s.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .backend import TorchScoringBackend, check_min_wide
from .dag import Task
from .simulator import Simulator, Strategy

_WIDE = 32  # ready-set size from which the batched numpy predictions win


class HEFT(Strategy):
    name = "heft"

    def __init__(self, device="cuda", min_wide: int = 1) -> None:
        """``device``: where the scoring matrices are computed (raises if
        it is ``cuda`` and no GPU is present). ``min_wide``: the narrowest
        activation scored on the device; narrower ones use the host rows."""
        self.backend = TorchScoringBackend(device)
        self.min_wide = check_min_wide(min_wide)

    def place(self, sim: Simulator, ready: List[Task], src: Optional[int]) -> None:
        machine = sim.machine
        resources = machine.resources
        cpus = machine.cpus
        gpus = machine.gpus
        cpu_cls = cpus[0].cls if cpus else gpus[0].cls
        gpu_cls = gpus[0].cls if gpus else cpu_cls

        n = len(ready)
        tids = [t.tid for t in ready]

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

        # per-resource duration columns
        cls_times = {cpu_cls.name: p_cpu, gpu_cls.name: p_gpu}
        cols = []
        for r in resources:
            col = cls_times.get(r.cls.name)
            if col is None:
                col = sim.predictor(r.cls).times_list(tids)
                cls_times[r.cls.name] = col
            cols.append(col)

        if n >= self.min_wide:
            X = self.backend.score_matrices(
                sim, tids, resources, use_cp=True, x_rows=True
            )["X_np"].tolist()
        else:
            X = sim.transfer_model.task_input_transfer_rows(
                sim.arrays, tids, [r.mem for r in resources], sim.residency
            )

        # --- worker selection: earliest finish time ----------------------
        load_ts = sim.load_ts
        now = sim.now
        n_res = len(resources)
        first_rid = resources[0].rid
        inf = float("inf")
        for i in order:
            xrow = X[i]
            best_eft = inf
            best_rid = first_rid
            for rid in range(n_res):
                lt = load_ts[rid]
                start = now if now > lt else lt
                eft = start + xrow[rid] + cols[rid][i]
                if eft < best_eft - 1e-15:
                    best_eft = eft
                    best_rid = rid
            load_ts[best_rid] = best_eft
            sim.push(ready[i], best_rid)
