"""Validate the port against the paper's experimental claims: the
counterpart of the reference's ``benchmarks/paper_validation.py``.

Runs the fig1–fig4 sweeps on one engine, then checks the claims on their
rows with the reference's formulas and thresholds (C1–C6), then, on the
exact engine whatever ``--engine`` says, C7 (the capacity sweep), C8 (GPU
churn: two of eight GPUs lost mid-run, one back late) and the two
verifier rows CV (the claim strategies' schedules, exact and surrogate,
re-checked by :mod:`repro_torch.verify`). Prints every row, a PASS/FAIL
table, the wall seconds of each figure and the engine's rate (simulation
runs a second on the exact engine, configurations a second on the
surrogate)::

    python -m repro_torch.bench.paper_validation [--engine exact|surrogate]
        [--runs 30] [--gpus 1,2,3,4,5,6,7,8] [--device cuda|cpu] [--audit]

The defaults are the paper's depth: 30 runs and 1..8 GPUs, on the card.
``--audit`` records every exact run of the figure sweeps and re-checks it
with the verifier (an error raises), as the reference's audit switch
does. Exits 1 when a claim fails.
"""
from __future__ import annotations

import argparse
import sys
import time
from functools import partial
from typing import Dict, List, Optional, Sequence

from ..configs.paper_machine import paper_machine
from ..core import Simulator, run_many
from ..core import episode as ep
from ..linalg.cholesky import cholesky_graph
from ..runtime.metrics import recovery_report
from ..verify import errors, verify_audit
from .common import ENGINES, NT, PAPER_GPUS, PAPER_RUNS, TILE, format_row, strategy_for, sweep
from .figures import FIGURES

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


# C8's fault script, as fractions of each strategy's own fault-free
# makespan: lose 2 of the 8 GPUs mid-run (one drained, one killed), get one
# back late
C8_FAULTS = ((0.25, "detach", 0, "drain"), (0.40, "detach", 1, "kill"),
             (0.60, "attach", 0, None))
C8_SPECS = (("heft", "heft"), ("dada", "dada?alpha=0.5&use_cp=1"))


def fault_recovery_runs(device="cuda") -> Dict[str, dict]:
    """HEFT and DADA(0.5)+CP (``C8_SPECS``) through the fault script
    ``C8_FAULTS`` on Cholesky NT 16, tile 512, ``paper_machine(8)``, seed
    0, noise 0: a fault-free baseline, then the faulted run, reduced to
    :func:`recovery_report` plus both runs' bytes and the faulted run's
    verifier errors (it is audited). The reference's
    ``fault_recovery_runs``, field for field."""
    graph = cholesky_graph(16, 512, with_fns=False)
    out = {}
    for label, spec in C8_SPECS:
        base = Simulator(graph, paper_machine(8), strategy_for(spec, device), seed=0,
                         noise=0.0).run()
        sim = Simulator(graph, paper_machine(8), strategy_for(spec, device), seed=0, noise=0.0,
                        audit=True)
        gpus = [r.rid for r in sim.machine.gpus]
        for frac, event, gi, mode in C8_FAULTS:
            sim.inject(event, gpus[gi], at=base.makespan * frac, mode=mode)
        res = sim.run()
        out[label] = dict(recovery_report(res, base), bytes=res.total_bytes,
                          baseline_bytes=base.total_bytes,
                          verify_errors=len(errors(verify_audit(sim.audit))))
    return out


def check_c8(device="cuda", reps: Optional[Dict[str, dict]] = None) -> dict:
    """C8 — through the churn script DADA(0.5)+CP moves no more data than
    HEFT, re-transfers and evacuations included, and both recover to
    completion with both detaches seen; every faulted run must also
    verify with no error. ``reps``: :func:`fault_recovery_runs`' output
    when the caller has it."""
    if reps is None:
        reps = fault_recovery_runs(device)
    dada_le = reps["dada"]["bytes"] <= reps["heft"]["bytes"]
    both_recover = all(r["slowdown"] > 0 and r["n_detaches"] == 2 for r in reps.values())
    verified = all(r["verify_errors"] == 0 for r in reps.values())
    return dict(
        claim="C8 GPU churn: DADA bytes <= HEFT through detach/reattach, both recover",
        measured="; ".join(
            f"{k}: {r['bytes'] / 1e9:.3f}GB ({r['extra_bytes'] / 1e6:+.1f}MB "
            f"over no-fault), recovery +{r['recovery_makespan'] * 1e3:.2f}ms "
            f"({r['slowdown']:.2f}x), evac {r['evacuated_bytes'] / 1e6:.1f}MB, "
            f"requeued {r['n_requeued']:.0f}"
            for k, r in reps.items()
        ) + f"; verifier errors {sum(r['verify_errors'] for r in reps.values())}",
        passed=dada_le and both_recover and verified,
        rows=reps,
    )


CV_SPECS = ("heft", "dada?alpha=0.5&use_cp=1", "ws")


def check_cv(device="cuda") -> List[dict]:
    """CV — the claim strategies' schedules pass the independent verifier:
    HEFT, DADA(0.5)+CP and ``ws`` on Cholesky NT 16 (``paper_machine(8)``,
    seed 0, noise 0), audited on the exact engine, and the same three
    through the surrogate (one episode batch with ``emit_schedule``, its
    logs from ``episode_audit_logs``). Two rows, as the reference's."""
    graph = cholesky_graph(16, 512, with_fns=False)
    machine = paper_machine(8)
    parts, n_err = [], 0
    for spec in CV_SPECS:
        sim = Simulator(graph, machine, strategy_for(spec, device), seed=0, noise=0.0,
                        audit=True)
        sim.run()
        e = len(errors(verify_audit(sim.audit)))
        n_err += e
        parts.append(f"{spec}: {e} err")
    exact = dict(claim="CV exact-engine claim schedules pass the independent verifier",
                 measured="; ".join(parts), passed=n_err == 0)
    max_mem = max(r.mem for r in machine.resources if r.is_accelerator)
    plan = ep.build_plan(graph, machine, n_u=max_mem + 2)
    batch = ep.config_batch(plan, [dict(machine=machine, strategy=spec, seed=0, noise=0.0)
                                   for spec in CV_SPECS])
    out = ep.run_episodes(plan, batch, device=device, emit_schedule=True)
    parts, n_err = [], 0
    for spec, log in zip(CV_SPECS, ep.episode_audit_logs(graph, batch, out)):
        e = len(errors(verify_audit(log)))
        n_err += e
        parts.append(f"{spec}: {e} err")
    surrogate = dict(claim="CV surrogate claim schedules pass the independent verifier",
                     measured="; ".join(parts), passed=n_err == 0)
    return [exact, surrogate]


def print_checks(checks: List[dict]) -> bool:
    ok = True
    print("\n== paper-claim validation ==")
    for c in checks:
        status = "PASS" if c["passed"] else "FAIL"
        ok &= c["passed"]
        print(f"  [{status}] {c['claim']}\n         measured: {c['measured']}")
    return ok


def run_figures(engine: str, n_runs: int, gpu_counts: Sequence[int], device="cuda",
                nt: int = NT, tile: int = TILE, audit: bool = False) -> Dict[str, dict]:
    """Every figure's rows and wall seconds: ``{name: {"rows", "wall_s"}}``.
    ``audit``: every exact run is audited and verified (an error raises)."""
    out = {}
    for name, (kernel, strategies) in FIGURES.items():
        t0 = time.perf_counter()
        rows = sweep(name, kernel, strategies, n_runs, gpu_counts, engine=engine, device=device,
                     nt=nt, tile=tile, audit=audit)
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
    ap.add_argument("--audit", action="store_true",
                    help="audit and verify every exact run of the figure sweeps")
    args = ap.parse_args(argv)
    gpus = [int(g) for g in args.gpus.split(",") if g.strip()]
    if not gpus:
        ap.error("--gpus needs at least one GPU count")
    if args.audit and args.engine != "exact":
        ap.error("--audit audits the exact engine's runs (the CV row audits the surrogate's)")

    t0 = time.perf_counter()
    figs = run_figures(args.engine, args.runs, gpus, device=args.device, audit=args.audit)
    for f in figs.values():
        for row in f["rows"]:
            print(format_row(row))
    checks = validate(*(f["rows"] for f in figs.values()), device=args.device)
    t7 = time.perf_counter()
    checks.append(check_c7(args.device))
    c7_s = time.perf_counter() - t7
    t8 = time.perf_counter()
    checks.append(check_c8(args.device))
    checks.extend(check_cv(args.device))
    c8_s = time.perf_counter() - t8
    ok = print_checks(checks)
    unit = "runs/s" if args.engine == "exact" else "configs/s"
    print(f"\nengine {args.engine} on {args.device}: {args.runs} runs x gpus {gpus}")
    for name, f in figs.items():
        print(f"  {name}: wall {f['wall_s']:.3f} s")
    print(f"  {rate(figs):.2f} {unit} over the figures; C7 {c7_s:.3f} s; C8 and CV "
          f"{c8_s:.3f} s; total wall {time.perf_counter() - t0:.3f} s (C6-C8 and CV included)")
    if not ok:
        print("some paper claims did not reproduce — see above", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
