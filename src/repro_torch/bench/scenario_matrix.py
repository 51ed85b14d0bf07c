"""The churn scenario matrix through the port (claim C9): the counterpart
of the reference's ``benchmarks/scenario_matrix.py``.

Sweeps churn rate × recovery mode × notice window × strategy over seeded
repetitions of LU on ``paper_machine(8)``. Every faulted run is scored by
:func:`~repro_torch.runtime.metrics.recovery_report` against its own
fault-free baseline (same graph, machine, strategy and seed), so slowdown
and extra bytes are what the faults cost.

Claim C9, per (churn, mode, strategy) and per cell:

  * a notice helps: with a notice window open, mean wasted seconds and
    mean reactive evacuation bytes do not exceed the blind (notice 0)
    run's;
  * C8 persists: the notice-aware dada(a)+cp+rec moves no more bytes than
    HEFT (within 5 %) in every (churn, mode, notice) cell;
  * recover beats notice-blind dada(a)+cp (within 2 %) while a notice is
    open.

Uncertainty is a seeded percentile-bootstrap 95 % CI over seed means::

    python -m repro_torch.bench.scenario_matrix [--runs 20] [--fast]
        [--device cuda|cpu]

``--fast`` is the reference's CI shape (3 seeds unless ``--runs`` says
otherwise, NT 6, churn 250); the default is its full depth (20 seeds, NT
12, churn 40 and 150). Prints every row and the claim table; exits 1 on a
failed C9 row. Writes no file.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..configs.paper_machine import paper_machine
from ..core import Simulator
from ..linalg.lu import lu_graph
from ..runtime.metrics import recovery_report
from .common import strategy_for

MODES = ("drain", "kill")
NOTICE_W = 0.008
STRATEGIES: Dict[str, str] = {
    "heft": "heft",
    "dada(a)+cp": "dada?alpha=0.5&use_cp=1",
    "dada(a)+cp+rec": "dada?alpha=0.5&use_cp=1&recover=1",
}
SEED0 = 1234
N_BOOT = 2000
N_GPUS = 8
# (seeds, NT, churn levels): the reference's full depth and its fast shape
FULL = (20, 12, (40.0, 150.0))
FAST = (3, 6, (250.0,))


def _boot_ci(xs: List[float], rng: np.random.Generator) -> Tuple[float, float]:
    """Seeded percentile-bootstrap 95 % CI of the mean."""
    arr = np.asarray(xs, dtype=np.float64)
    if arr.size < 2:
        v = float(arr[0]) if arr.size else 0.0
        return v, v
    means = rng.choice(arr, size=(N_BOOT, arr.size), replace=True).mean(axis=1)
    lo, hi = np.percentile(means, (2.5, 97.5))
    return float(lo), float(hi)


def run_matrix(n_seeds: int = FULL[0], nt: int = FULL[1],
               churn_levels: Sequence[float] = FULL[2], device="cuda",
               verbose: bool = True) -> Tuple[List[dict], List[dict]]:
    """The matrix's rows and C9's checks (the reference's, field for
    field), every run on ``device``."""
    graph = lu_graph(nt, 512, with_fns=False)
    if verbose:
        print(f"scenario matrix: NT={nt}, {n_seeds} seeds, churn {tuple(churn_levels)}, "
              f"modes {MODES}, notice (0.0, {NOTICE_W:g}), {len(STRATEGIES)} strategies",
              flush=True)

    def run(spec, i, **faults):
        return Simulator(graph, paper_machine(N_GPUS), strategy_for(spec, device),
                         seed=SEED0 + i, noise=0.0, **faults).run()

    # fault-free baselines per (strategy, seed), shared by every cell
    baselines = {(label, i): run(spec, i) for label, spec in STRATEGIES.items()
                 for i in range(n_seeds)}
    rows: List[dict] = []
    cells: Dict[tuple, dict] = {}
    for churn in churn_levels:
        for mode in MODES:
            for notice in (0.0, NOTICE_W):
                for label, spec in STRATEGIES.items():
                    reports, bytes_f = [], []
                    for i in range(n_seeds):
                        res = run(spec, i, churn=churn, fault_mode=mode, notice_s=notice)
                        reports.append(recovery_report(res, baselines[(label, i)]))
                        bytes_f.append(float(res.total_bytes))
                    rng = np.random.default_rng((SEED0, int(churn), MODES.index(mode),
                                                 int(notice * 1e6), sorted(STRATEGIES).index(label)))
                    slow = [r["slowdown"] for r in reports]
                    extra = [r["extra_bytes"] for r in reports]
                    s_lo, s_hi = _boot_ci(slow, rng)
                    b_lo, b_hi = _boot_ci(extra, rng)

                    def mean(k):
                        return float(np.mean([r.get(k, 0.0) for r in reports]))

                    row = dict(
                        kernel="lu", nt=nt, n_gpus=N_GPUS, churn=churn, fault_mode=mode,
                        notice=notice, strategy=label, n_seeds=n_seeds,
                        slowdown_mean=round(float(np.mean(slow)), 4),
                        slowdown_ci95=[round(s_lo, 4), round(s_hi, 4)],
                        extra_bytes_mean=round(float(np.mean(extra)), 1),
                        extra_bytes_ci95=[round(b_lo, 1), round(b_hi, 1)],
                        total_bytes_mean=round(float(np.mean(bytes_f)), 1),
                        wasted_s_mean=round(mean("wasted_s"), 6),
                        reactive_bytes_mean=round(mean("reactive_evacuated_bytes"), 1),
                        proactive_bytes_mean=round(mean("proactive_bytes"), 1),
                        n_detaches_mean=round(mean("n_detaches"), 2),
                        n_notices_mean=round(mean("n_notices"), 2),
                    )
                    rows.append(row)
                    cells[(churn, mode, notice, label)] = row
                    if verbose:
                        print(f"  churn={churn:g} {mode:5s} notice={notice:g} {label:14s} "
                              f"slowdown {row['slowdown_mean']:.3f} [{s_lo:.3f},{s_hi:.3f}]  "
                              f"wasted {row['wasted_s_mean']:.4g}s  "
                              f"reactive {row['reactive_bytes_mean'] / 1e6:.1f}MB  "
                              f"proactive {row['proactive_bytes_mean'] / 1e6:.1f}MB", flush=True)
    return rows, c9_checks(cells, churn_levels)


def c9_checks(cells: Dict[tuple, dict], churn_levels: Sequence[float]) -> List[dict]:
    """C9's rows over the matrix's cells, keyed (churn, mode, notice,
    strategy label), with the reference's formulas and margins."""
    checks: List[dict] = []
    for churn in churn_levels:
        for mode in MODES:
            for label in STRATEGIES:
                blind = cells[(churn, mode, 0.0, label)]
                noted = cells[(churn, mode, NOTICE_W, label)]
                checks.append(dict(
                    claim=f"C9 notice cuts waste: churn={churn:g} {mode} {label}",
                    measured=(
                        f"wasted {blind['wasted_s_mean']:.4g}->{noted['wasted_s_mean']:.4g}s, "
                        f"reactive {blind['reactive_bytes_mean'] / 1e6:.1f}->"
                        f"{noted['reactive_bytes_mean'] / 1e6:.1f}MB "
                        f"(proactive {noted['proactive_bytes_mean'] / 1e6:.1f}MB)"
                    ),
                    passed=(noted["wasted_s_mean"] <= blind["wasted_s_mean"] + 1e-9
                            and noted["reactive_bytes_mean"]
                            <= blind["reactive_bytes_mean"] * 1.05 + 1.0),
                ))
            for notice in (0.0, NOTICE_W):
                heft = cells[(churn, mode, notice, "heft")]
                dada = cells[(churn, mode, notice, "dada(a)+cp+rec")]
                checks.append(dict(
                    claim=f"C9/C8 dada+rec bytes <= heft: churn={churn:g} {mode} notice={notice:g}",
                    measured=(f"dada+rec {dada['total_bytes_mean'] / 1e9:.3f}GB "
                              f"vs heft {heft['total_bytes_mean'] / 1e9:.3f}GB"),
                    passed=dada["total_bytes_mean"] <= heft["total_bytes_mean"] * 1.05,
                ))
            cp = cells[(churn, mode, NOTICE_W, "dada(a)+cp")]
            rec = cells[(churn, mode, NOTICE_W, "dada(a)+cp+rec")]
            checks.append(dict(
                claim=f"C9 recover beats notice-blind dada: churn={churn:g} {mode}",
                measured=(f"bytes {cp['total_bytes_mean'] / 1e9:.3f}->"
                          f"{rec['total_bytes_mean'] / 1e9:.3f}GB, slowdown "
                          f"{cp['slowdown_mean']:.3f}->{rec['slowdown_mean']:.3f}"),
                passed=rec["total_bytes_mean"] <= cp["total_bytes_mean"] * 1.02,
            ))
    return checks


def print_checks(checks: List[dict]) -> bool:
    """The claim table; True when every row passed."""
    print("\n== scenario-matrix claims ==")
    ok = True
    for c in checks:
        ok = ok and c["passed"]
        print(f"  [{'PASS' if c['passed'] else 'FAIL'}] {c['claim']}\n"
              f"         measured: {c['measured']}")
    return ok


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.scenario_matrix",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=None,
                    help=f"seeds per cell (default {FULL[0]}, {FAST[0]} with --fast)")
    ap.add_argument("--fast", action="store_true", help="the CI shape: NT 6, churn 250")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    seeds, nt, churn = FAST if args.fast else FULL
    if args.runs is not None:
        if args.runs < 1:
            ap.error("--runs must be >= 1")
        seeds = args.runs
    t0 = time.perf_counter()
    _rows, checks = run_matrix(seeds, nt, churn, device=args.device)
    ok = print_checks(checks)
    print(f"\ntotal wall-clock {time.perf_counter() - t0:.1f}s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
