"""Validate the port against the paper's experimental claims C1–C7: the
counterpart of the reference's ``benchmarks/paper_validation.py``.

Runs the fig1–fig4 sweeps on one engine, then checks the claims on their
rows with the reference's formulas and thresholds, then C7 (the capacity
sweep, on the exact engine whatever ``--engine`` says), and prints every
row, a PASS/FAIL table, the wall seconds of each figure and the engine's
rate (simulation runs a second on the exact engine, configurations a
second on the surrogate)::

    python -m repro_torch.bench.paper_validation [--engine exact|surrogate]
        [--runs 30] [--gpus 1,2,3,4,5,6,7,8] [--device cuda|cpu]

The defaults are the paper's depth: 30 runs and 1..8 GPUs, on the card.
Exits 1 when a claim fails. C8 and the verifier rows of the reference
need the fault-injected runtime, which the port does not have yet.
"""
from __future__ import annotations

import argparse
import sys
import time
from functools import partial
from typing import Dict, List, Optional, Sequence

from ..configs.paper_machine import paper_machine
from ..core import Simulator, run_many
from ..linalg.cholesky import cholesky_graph
from ..verify import errors, verify_audit
from .common import ENGINES, NT, PAPER_GPUS, PAPER_RUNS, TILE, format_row, strategy_for, sweep
from .figures import FIGURES

NOT_CHECKED = ("C8 and the verifier rows are not checked: the port has no "
               "fault-injected runtime yet")

_MB = 1024 * 1024
# the capacity sweep's points: unbounded (0) down to 32 MB a GPU memory
C7_CAPACITIES = (0, 128 * _MB, 64 * _MB, 32 * _MB)


def _get(rows: List[dict], strategy: str, n_gpus: int, field: str):
    for r in rows:
        if r["strategy"] == strategy and r["n_gpus"] == n_gpus:
            return r[field]
    raise KeyError((strategy, n_gpus, field))


def validate_rows(fig1: List[dict], fig2: List[dict], fig3: List[dict], fig4: List[dict]) -> List[dict]:
    """C1–C5 on the figure rows (the reference's ``validate`` up to C6)."""
    checks: List[dict] = []
    gpus = sorted({r["n_gpus"] for r in fig1})
    lo, hi = gpus[0], gpus[-1]

    # C1 — DADA(0) without CP stops scaling with many GPUs
    try:
        s0 = _get(fig1, "dada(0)", hi, "gflops") / _get(fig1, "dada(0)", lo, "gflops")
        s1 = _get(fig1, "dada(1)", hi, "gflops") / _get(fig1, "dada(1)", lo, "gflops")
        checks.append(dict(
            claim="C1 dada(0) scales worse than dada(1)",
            measured=f"speedup {lo}->{hi} gpus: dada(0) {s0:.2f}x vs dada(1) {s1:.2f}x",
            passed=s0 < s1,
        ))
    except KeyError:
        pass

    # C2 — higher alpha scales better
    try:
        perf = [(a, _get(fig1, f"dada({a:g})", hi, "gflops")) for a in (0.25, 0.5, 0.75, 1.0)]
        checks.append(dict(
            claim="C2 higher alpha => better at max gpus",
            measured="; ".join(f"a={a:g}:{g:.0f}GF" for a, g in perf),
            passed=perf[-1][1] >= perf[0][1],
        ))
    except KeyError:
        pass

    # C3 — LU: DADA(a)+CP moves much less data than HEFT
    heft_gb = _get(fig3, "heft", hi, "gbytes")
    dada_gb = _get(fig3, "dada(a)+cp", hi, "gbytes")
    heft_gf = _get(fig3, "heft", hi, "gflops")
    dada_gf = _get(fig3, "dada(a)+cp", hi, "gflops")
    factor = heft_gb / dada_gb
    slow = heft_gf / dada_gf
    checks.append(dict(
        claim="C3 LU: dada(a)+cp lowest transfers (paper: 3.5x, ~1.13x slowdown)",
        measured=f"transfer factor {factor:.2f}x, perf ratio {slow:.2f}x",
        passed=factor > 1.0 and slow < 1.25,
    ))

    # C4 — QR: HEFT outperforms every dual-approximation variant
    duals = ["dada(0)", "dada(a)", "dada(a)+cp"]
    heft_qr = _get(fig4, "heft", hi, "gflops")
    worst = max(_get(fig4, d, hi, "gflops") for d in duals)
    checks.append(dict(
        claim="C4 QR: HEFT >= all dual approximations",
        measured=f"heft {heft_qr:.0f}GF vs best dual {worst:.0f}GF",
        passed=heft_qr >= worst * 0.97,
    ))

    # C5 — Cholesky: DADA(a) within range of HEFT (similar performance)
    heft_ch = _get(fig2, "heft", hi, "gflops")
    dada_ch = _get(fig2, "dada(a)", hi, "gflops")
    checks.append(dict(
        claim="C5 Cholesky: dada(a) ~ heft at max gpus",
        measured=f"dada(a) {dada_ch:.0f}GF vs heft {heft_ch:.0f}GF",
        passed=dada_ch >= heft_ch * 0.8,
    ))
    return checks


def check_c6(n_runs: int = 10, device="cuda") -> dict:
    """C6 — work stealing is cache-unfriendly on small matrices: Cholesky
    NT 8 on four GPUs, ``ws`` against DADA(0.5), on the exact engine."""
    machine = paper_machine(4)
    small = partial(cholesky_graph, 8, 512, with_fns=False)  # 4096^2
    ws = run_many(small, machine, partial(strategy_for, "ws", device), n_runs)
    da = run_many(small, machine, partial(strategy_for, "dada?alpha=0.5", device), n_runs)
    return dict(
        claim="C6 small matrix: affinity beats work stealing",
        measured=f"ws {ws.gflops_mean:.0f}GF/{ws.gbytes_mean:.2f}GB vs "
        f"dada(a) {da.gflops_mean:.0f}GF/{da.gbytes_mean:.2f}GB",
        passed=da.gflops_mean > ws.gflops_mean,
        ws=ws, dada=da,
    )


def validate(fig1: List[dict], fig2: List[dict], fig3: List[dict], fig4: List[dict],
             n_runs: int = 10, device="cuda") -> List[dict]:
    """C1–C5 on the rows, then C6, which runs its own simulations."""
    return validate_rows(fig1, fig2, fig3, fig4) + [check_c6(n_runs, device)]


def capacity_sweep(capacities=C7_CAPACITIES, device="cuda") -> List[dict]:
    """Total transferred bytes of HEFT against DADA(0.5)+CP on Cholesky NT
    16 (``paper_machine(8)``) as the device-memory capacity shrinks, with
    affinity eviction, noise 0 and seed 0: the reference's rows (bytes and
    write-back bytes a strategy, the gap), plus each run's verifier
    errors, every run audited and verified."""
    machine = paper_machine(8)
    graph = cholesky_graph(16, 512, with_fns=False)
    rows = []
    for cap in capacities:
        row = dict(capacity=cap)
        for label, spec in (("heft", "heft"), ("dada", "dada?alpha=0.5&use_cp=1")):
            sim = Simulator(graph, machine, strategy_for(spec, device), seed=0, noise=0.0,
                            mem_capacity=cap, eviction="affinity", audit=True)
            res = sim.run()
            row[label] = res.total_bytes
            row[f"{label}_writeback"] = sim.metrics.writeback_bytes
            row[f"{label}_verify_errors"] = len(errors(verify_audit(sim.audit)))
        row["gap"] = row["heft"] - row["dada"]
        rows.append(row)
    return rows


def check_c7(device="cuda", rows: Optional[List[dict]] = None) -> dict:
    """C7 — under memory pressure DADA moves no more data than HEFT at
    every capacity, and the gap does not shrink as the capacity drops;
    every run of the sweep must also verify with no error. ``rows``: the
    sweep's rows when the caller has run it, else it runs here."""
    if rows is None:
        rows = capacity_sweep(device=device)
    le_everywhere = all(r["dada"] <= r["heft"] for r in rows)
    gaps = [r["gap"] for r in rows]
    non_shrinking = all(b >= a for a, b in zip(gaps, gaps[1:]))
    verified = all(r["heft_verify_errors"] == r["dada_verify_errors"] == 0 for r in rows)

    def cap(c):
        return "inf" if c == 0 else f"{c // _MB}MB"

    return dict(
        claim="C7 capacity sweep: DADA bytes <= HEFT, gap non-shrinking as memory shrinks",
        measured="; ".join(
            f"{cap(r['capacity'])}: heft {r['heft'] / 1e9:.3f}GB "
            f"dada {r['dada'] / 1e9:.3f}GB (gap {r['gap'] / 1e6:+.1f}MB)"
            for r in rows
        ) + f"; verifier errors {sum(r['heft_verify_errors'] + r['dada_verify_errors'] for r in rows)}",
        passed=le_everywhere and non_shrinking and verified,
        rows=rows,
    )


def print_checks(checks: List[dict]) -> bool:
    ok = True
    print("\n== paper-claim validation ==")
    for c in checks:
        status = "PASS" if c["passed"] else "FAIL"
        ok &= c["passed"]
        print(f"  [{status}] {c['claim']}\n         measured: {c['measured']}")
    print(f"  ({NOT_CHECKED})")
    return ok


def run_figures(engine: str, n_runs: int, gpu_counts: Sequence[int], device="cuda",
                nt: int = NT, tile: int = TILE) -> Dict[str, dict]:
    """Every figure's rows and wall seconds: ``{name: {"rows", "wall_s"}}``."""
    out = {}
    for name, (kernel, strategies) in FIGURES.items():
        t0 = time.perf_counter()
        rows = sweep(name, kernel, strategies, n_runs, gpu_counts, engine=engine, device=device,
                     nt=nt, tile=tile)
        out[name] = {"rows": rows, "wall_s": time.perf_counter() - t0}
    return out


def rate(figs: Dict[str, dict]) -> float:
    """Simulation runs (exact) or configurations (surrogate) a second over
    all figures: each row is ``n_runs`` of them."""
    n = sum(r["n_runs"] for f in figs.values() for r in f["rows"])
    wall = sum(f["wall_s"] for f in figs.values())
    return n / wall if wall > 0 else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.paper_validation",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=ENGINES, default="exact")
    ap.add_argument("--runs", type=int, default=PAPER_RUNS, help="seeded runs per configuration")
    ap.add_argument("--gpus", default=",".join(map(str, PAPER_GPUS)),
                    help="comma list of GPU counts (0..8)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    gpus = [int(g) for g in args.gpus.split(",") if g.strip()]
    if not gpus:
        ap.error("--gpus needs at least one GPU count")

    t0 = time.perf_counter()
    figs = run_figures(args.engine, args.runs, gpus, device=args.device)
    for f in figs.values():
        for row in f["rows"]:
            print(format_row(row))
    checks = validate(*(f["rows"] for f in figs.values()), device=args.device)
    t7 = time.perf_counter()
    checks.append(check_c7(args.device))
    c7_s = time.perf_counter() - t7
    ok = print_checks(checks)
    unit = "runs/s" if args.engine == "exact" else "configs/s"
    print(f"\nengine {args.engine} on {args.device}: {args.runs} runs x gpus {gpus}")
    for name, f in figs.items():
        print(f"  {name}: wall {f['wall_s']:.3f} s")
    print(f"  {rate(figs):.2f} {unit} over the figures; C7 {c7_s:.3f} s; "
          f"total wall {time.perf_counter() - t0:.3f} s (C6 and C7 included)")
    if not ok:
        print("some paper claims did not reproduce — see above", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
