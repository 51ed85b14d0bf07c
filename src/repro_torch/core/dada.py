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

Counterpart of ``repro.core.dada``. Everything λ-independent is computed
once per activation: the cost matrix ``C = p + xfer``, the per-row
transfer maxima and the affinity scores come from the device backend for
activations at least ``min_wide`` wide (default 1: every activation) and
from the host rows otherwise. The λ search and ``try_build`` then run on
the host over those rows, in the reference's order, so decisions
(including tie-breaks) are bit-identical to ``repro``'s.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .affinity import RESIDENT_WEIGHTED, affinity_rows
from .backend import TorchScoringBackend, check_min_wide
from .dag import Task
from .simulator import Simulator, Strategy

_TINY = 1e-12
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
        device="cuda",
        min_wide: int = 1,
    ) -> None:
        """``area_bound``: also reject a guess λ when the total work area
        exceeds λ x (number of resources) — a valid no-schedule
        certificate. Off by default (the paper's Algorithm 2 rejects only
        on the big-task criterion).

        ``device``: where the scoring matrices are computed (raises if it
        is ``cuda`` and no GPU is present). ``min_wide``: the narrowest
        activation scored on the device; narrower ones use the host rows.
        """
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be within [0, 1]")
        if affinity not in RESIDENT_WEIGHTED:
            raise ValueError(
                f"unknown affinity {affinity!r} (choose from {RESIDENT_WEIGHTED})"
            )
        self.alpha = alpha
        self.use_cp = use_cp
        self.affinity_name = affinity
        self.eps_rel = eps_rel
        self.max_iters = max_iters
        self.area_bound = area_bound
        self.backend = TorchScoringBackend(device)
        self.min_wide = check_min_wide(min_wide)
        cp = "+cp" if use_cp else ""
        self.name = f"dada({alpha:g}){cp}"

    # ------------------------------------------------------------------
    def place(self, sim: Simulator, ready: List[Task], src: Optional[int]) -> None:
        machine = sim.machine
        resources = machine.resources
        cpus = machine.cpus
        gpus = machine.gpus
        cpu_cls = cpus[0].cls if cpus else gpus[0].cls
        gpu_cls = gpus[0].cls if gpus else cpu_cls
        n_res = len(resources)
        n = len(ready)
        tids = [t.tid for t in ready]

        # --- λ-independent precomputation --------------------------------
        if n >= _WIDE:
            tids_arr = np.asarray(tids, dtype=np.int64)
            p_cpu = sim.predictor(cpu_cls).times(tids_arr).tolist()
            p_gpu = sim.predictor(gpu_cls).times(tids_arr).tolist()
        else:
            p_cpu = sim.predictor(cpu_cls).times_list(tids)
            p_gpu = sim.predictor(gpu_cls).times_list(tids)

        # fused scoring on the device: C, the per-row transfer maxima and
        # the affinity matrix, bit-equal to the host formulas below
        fused = None
        if n >= self.min_wide:
            fused = self.backend.score_matrices(
                sim, tids, resources,
                p_cpu=p_cpu, p_gpu=p_gpu,
                use_cp=self.use_cp,
                affinity=self.affinity_name if self.alpha > 0.0 else None,
            )
            X = None  # worst-case transfer bound: fused["X_rowmax"] below
            C_rows = fused["C"]
        else:
            X = (
                sim.transfer_model.task_input_transfer_rows(
                    sim.arrays, tids, [r.mem for r in resources], sim.residency
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
        offsets = [
            lt - sim.now if lt - sim.now > 0.0 else 0.0
            for lt in (sim.load_ts[r.rid] for r in resources)
        ]

        # affinity preferences per task, with the placement cost prefetched:
        # (score, tid, rid, cost), sorted by (-score, tid)
        by_score: List[Tuple[float, int, int, float]] = []
        if self.alpha > 0.0 and fused is not None:
            # one pass per resource column reproduces the scalar
            # rid-ascending tolerance scan row by row; the (-score, tid)
            # lexsort matches sorted() because tids are unique
            S_np = fused["S_np"]
            best = np.zeros(n, dtype=np.float64)
            best_rid = np.full(n, -1, dtype=np.int64)
            for rid in range(n_res):
                col = S_np[:, rid]
                upd = col > best + _TINY
                if upd.any():
                    best[upd] = col[upd]
                    best_rid[upd] = rid
            sel = np.nonzero(best_rid >= 0)[0]
            if len(sel):
                scores = best[sel]
                prids = best_rid[sel]
                ptids = np.asarray(tids, dtype=np.int64)[sel]
                pcosts = fused["C_np"][sel, prids]
                order_p = np.lexsort((ptids, -scores))
                by_score = list(
                    zip(
                        scores[order_p].tolist(),
                        ptids[order_p].tolist(),
                        prids[order_p].tolist(),
                        pcosts[order_p].tolist(),
                    )
                )
        elif self.alpha > 0.0:
            pref: List[Tuple[float, int, int, float]] = []
            S_rows = affinity_rows(
                self.affinity_name, sim.arrays, tids, resources, sim.residency
            )
            for i, row in enumerate(S_rows):
                if not any(row):
                    continue  # all-zero row: no preference
                best_score, best_r = 0.0, -1
                for rid in range(n_res):
                    s = row[rid]
                    if s > best_score + _TINY:
                        best_score, best_r = s, rid
                if best_r >= 0:
                    pref.append((best_score, tids[i], best_r, C_rows[i][best_r]))
            by_score = sorted(pref, key=lambda x: (-x[0], x[1]))

        # speedup sort keys for the flexible phase (λ-independent)
        skey = [-(pc / max(pg, _TINY)) for pc, pg in zip(p_cpu, p_gpu)]

        cpu_rids = [r.rid for r in cpus]
        gpu_rids = [r.rid for r in gpus]
        any_rids = cpu_rids or gpu_rids
        have_both = bool(cpu_rids and gpu_rids)
        no_cpus = not cpu_rids
        no_gpus = not gpu_rids

        if self.area_bound:
            area = sum(min(pc, pg) for pc, pg in zip(p_cpu, p_gpu))
            off_total = sum(offsets)

        all_idx = list(range(n))
        # global flex order (λ-independent): per-probe flex sets are subsets
        # of ready, so filtering this order equals sorting each subset
        if n >= _WIDE:
            flex_order = np.lexsort(
                (np.asarray(tids, dtype=np.int64), np.asarray(skey))
            ).tolist()
        else:
            flex_order = sorted(all_idx, key=lambda i: (skey[i], tids[i]))
        alpha = self.alpha
        two_alpha = 2.0 + alpha
        area_bound = self.area_bound
        max_off = max(offsets, default=0.0)

        # ------------------------------------------------------------------
        def try_build(lam: float) -> Optional[Tuple[Dict[int, int], List[float]]]:
            # loads only grow, so the first overflow of (2+α)λ already
            # decides the probe: same verdict as building fully
            cap = two_alpha * lam + _TINY
            if max_off > cap:
                return None
            if area_bound:
                capacity = lam * n_res - off_total
                if area > capacity + _TINY:
                    return None  # certificate: no λ-schedule exists
            loads = offsets.copy()
            assign: Dict[int, int] = {}

            # ---- local affinity phase (line 5-7) -------------------------
            if by_score:
                budget = alpha * lam + _TINY
                for sc, tid, rid, c in by_score:
                    if loads[rid] <= budget:
                        assign[tid] = rid
                        v = loads[rid] + c
                        if v > cap:
                            return None
                        loads[rid] = v

            # ---- global balance phase (line 8-9) -------------------------
            if assign:
                rem = [i for i in all_idx if tids[i] not in assign]
            else:
                rem = all_idx
            for i in rem:  # reject if a task is larger than λ everywhere
                big_cpu = no_cpus or p_cpu[i] > lam
                big_gpu = no_gpus or p_gpu[i] > lam
                if big_cpu and big_gpu:
                    return None

            flex = None
            if have_both:
                flex = bytearray(n)
                for i in rem:
                    if p_cpu[i] > lam:
                        pool_rids = gpu_rids  # dedicated to GPUs
                    elif p_gpu[i] > lam:
                        pool_rids = cpu_rids  # dedicated to CPUs
                    else:
                        flex[i] = 1
                        continue
                    # earliest finish time; first minimum wins
                    crow = C_rows[i]
                    best_v = float("inf")
                    best_rid = pool_rids[0]
                    for rid in pool_rids:
                        v = loads[rid] + crow[rid]
                        if v < best_v:
                            best_v = v
                            best_rid = rid
                    if best_v > cap:
                        return None
                    assign[tids[i]] = best_rid
                    loads[best_rid] = best_v
            else:
                for i in rem:
                    crow = C_rows[i]
                    best_v = float("inf")
                    best_rid = any_rids[0]
                    for rid in any_rids:
                        v = loads[rid] + crow[rid]
                        if v < best_v:
                            best_v = v
                            best_rid = rid
                    if best_v > cap:
                        return None
                    assign[tids[i]] = best_rid
                    loads[best_rid] = best_v

            # flexible tasks: largest speedup first, to GPUs up to
            # overreaching λ, the rest to CPUs (earliest finish time)
            if flex is not None:
                gpu_budget = lam + _TINY
                for i in flex_order:
                    if not flex[i]:
                        continue
                    g = gpu_rids[0]
                    gl = loads[g]
                    for rid in gpu_rids[1:]:
                        if loads[rid] < gl:
                            gl = loads[rid]
                            g = rid
                    if gl <= gpu_budget:
                        v = gl + C_rows[i][g]
                        if v > cap:
                            return None
                        assign[tids[i]] = g
                        loads[g] = v
                        continue
                    crow = C_rows[i]
                    best_v = float("inf")
                    best_rid = any_rids[0]
                    for rid in any_rids:
                        v = loads[rid] + crow[rid]
                        if v < best_v:
                            best_v = v
                            best_rid = rid
                    if best_v > cap:
                        return None
                    assign[tids[i]] = best_rid
                    loads[best_rid] = best_v

            # acceptance (line 10) already enforced incrementally above
            return assign, loads

        # ------------------------------------------------------------------
        # binary search on λ (classical dual-approximation driver)
        worst_xfer = 0.0
        if fused is not None and fused["X_rowmax"] is not None:
            for v in fused["X_rowmax"]:
                worst_xfer += v
        elif X is not None:
            for xrow in X:
                worst_xfer += max(xrow)
        upper = (
            sum(max(pc, pg) for pc, pg in zip(p_cpu, p_gpu))
            + max_off
            + worst_xfer
            + _TINY
        )
        lower = 0.0
        kept: Optional[Tuple[Dict[int, int], List[float]]] = None
        it = 0
        while upper - lower > self.eps_rel * upper and it < self.max_iters:
            lam = (upper + lower) / 2.0
            built = try_build(lam)
            if built is not None:
                upper = lam
                kept = built
            else:
                lower = lam
            it += 1
        if kept is None:
            kept = try_build(upper)
            if kept is None:
                raise RuntimeError("DADA: λ=upper must always be feasible")

        assign, loads = kept
        # expose the accepted guess for tests / introspection
        self.last_lambda = upper
        self.last_loads = {r.rid: loads[j] for j, r in enumerate(resources)}
        for t in ready:
            sim.push(t, assign[t.tid])
        for j, r in enumerate(resources):
            sim.load_ts[r.rid] = sim.now + loads[j]


class DualApprox(DADA):
    """Plain ρ=2 dual approximation — DADA with the affinity phase off."""

    def __init__(self, use_cp: bool = False, **kw) -> None:
        super().__init__(alpha=0.0, use_cp=use_cp, **kw)
        self.name = "dual" + ("+cp" if use_cp else "")
