"""Open-loop serving load through the port: the counterpart of the
reference's ``benchmarks/serving_load.py``.

Sweeps tenant count × arrival process × strategy over the graph catalog
(:func:`repro_torch.runtime.load.default_catalog`) on ``paper_machine(4)``,
each configuration one :func:`run_serving` with incremental rescoring, its
pool's rows scored on the device. Each row reports the engine's
throughput (events a second, wall seconds, rounds, rows built) and what
tenants see: p50 / p99 makespan and slowdown against the empty-machine
baseline, queueing delay, Jain's fairness, and the admission counters.

The speed-up probe replays one Poisson stream of 256 tenants twice, with
``rescore="full"`` (every row rebuilt every round) and with
``rescore="incremental"`` (dirty rows only), both cut at the same event
count; the two place alike, so the ratio of their rates is the scoring
work the incremental pool saves::

    python -m repro_torch.bench.serving_load [--tenants 16,64,256,1024]
        [--rate 2000] [--device cuda|cpu] [--probe-events 4000]

Prints each row and one JSON line; writes no file. The reference's
``calibration_score`` (from its scheduler-overhead benchmark) is not part
of the port yet.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Sequence

from ..configs.paper_machine import paper_machine
from ..runtime.load import make_arrivals, run_serving

TENANTS = (16, 64, 256, 1024)
ARRIVALS = ("poisson", "bursty", "diurnal")
STRATEGIES = ("heft", "dada?alpha=0.5&use_cp=1", "wfq")
STRATEGY_LABELS = {"heft": "heft", "dada?alpha=0.5&use_cp=1": "dada(a)+cp", "wfq": "wfq"}
DEFAULT_RATE = 2000.0
PROBE_EVENTS = 4000
PROBE_TENANTS = 256
WALL_FIELDS = ("wall_s", "events_per_s")  # the fields a run's timing sets


def _timed(reps: int, fn):
    """(best wall s over ``reps`` calls, the last call's result)."""
    dt, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = min(dt, time.perf_counter() - t0)
    return dt, out


def serving_rows(tenant_counts: Sequence[int], rate: float = DEFAULT_RATE, device="cuda",
                 reps: int = 2) -> List[dict]:
    """One row per tenant count × arrival process × strategy (arrivals
    from seed 7, runs at seed 0, best wall of ``reps``), the reference's
    fields plus ``rounds``, the pool's placement rounds."""
    machine = paper_machine(4)
    rows = []
    # the slowdown denominators, per (strategy, kind), shared by the sweep
    baselines: Dict[str, dict] = {spec: {} for spec in STRATEGIES}
    for tenants in tenant_counts:
        for arrival in ARRIVALS:
            arr = make_arrivals(arrival, tenants, rate=rate, seed=7)
            for spec in STRATEGIES:
                dt, out = _timed(reps, lambda: run_serving(
                    arr, machine, spec, seed=0, rescore="incremental",
                    baselines=baselines[spec], device=device))
                rep = out["report"]
                rows.append(dict(
                    tenants=tenants, arrival=arrival, strategy=STRATEGY_LABELS[spec],
                    rescore="incremental", rate=rate, wall_s=round(dt, 4),
                    events=out["n_events"],
                    events_per_s=round(out["n_events"] / dt, 1) if dt > 0 else 0.0,
                    rows_built=out["rows_built"], n_admitted=out["n_admitted"],
                    n_rejected=out["n_rejected"], p50_makespan=rep["p50_makespan"],
                    p99_makespan=rep["p99_makespan"], p50_slowdown=rep["p50_slowdown"],
                    p99_slowdown=rep["p99_slowdown"], p50_queue_delay=rep["p50_queue_delay"],
                    p99_queue_delay=rep["p99_queue_delay"],
                    mean_slowdown=rep["mean_slowdown"], jain_fairness=rep["jain_fairness"],
                    rounds=out["engine"]._serving.n_rounds,
                ))
    return rows


def speedup_probe(tenants: int = PROBE_TENANTS, rate: float = DEFAULT_RATE, device="cuda",
                  max_events: int = PROBE_EVENTS, reps: int = 2) -> dict:
    """``full`` against ``incremental`` on one Poisson stream under HEFT,
    both cut at ``max_events``: each mode's wall s, events, events a
    second, rows built and rounds, and the speed-up."""
    machine = paper_machine(4)
    arr = make_arrivals("poisson", tenants, rate=rate, seed=7)
    probe = {}
    for mode in ("full", "incremental"):
        dt, out = _timed(reps, lambda: run_serving(arr, machine, "heft", seed=0, rescore=mode,
                                                   max_events=max_events, device=device))
        probe[mode] = dict(
            wall_s=round(dt, 4), events=out["n_events"],
            events_per_s=round(out["n_events"] / dt, 1) if dt > 0 else 0.0,
            rows_built=out["rows_built"], rounds=out["engine"]._serving.n_rounds,
        )
    full_ev = probe["full"]["events_per_s"]
    speedup = round(probe["incremental"]["events_per_s"] / full_ev, 2) if full_ev > 0 else 0.0
    return dict(tenants=tenants, arrival="poisson", strategy="heft", max_events=max_events,
                rate=rate, full=probe["full"], incremental=probe["incremental"],
                speedup=speedup)


def format_row(row: dict) -> str:
    return (f"serving/{row['arrival']}/{row['strategy']}/tenants{row['tenants']} "
            f"wall_s={row['wall_s']} events={row['events']} events_per_s={row['events_per_s']} "
            f"rounds={row['rounds']} rows_built={row['rows_built']} "
            f"p50_slowdown={row['p50_slowdown']!r} p99_slowdown={row['p99_slowdown']!r} "
            f"jain={row['jain_fairness']!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.serving_load",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--tenants", default=",".join(map(str, TENANTS)),
                    help="comma-separated tenant counts")
    ap.add_argument("--rate", type=float, default=DEFAULT_RATE, help="arrivals a simulated second")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--probe-events", type=int, default=PROBE_EVENTS,
                    help="events each mode of the speed-up probe replays")
    args = ap.parse_args(argv)
    tenant_counts = [int(x) for x in args.tenants.split(",") if x]
    rows = serving_rows(tenant_counts, args.rate, device=args.device)
    for row in rows:
        print(format_row(row), flush=True)
    probe = speedup_probe(PROBE_TENANTS, args.rate, device=args.device,
                          max_events=args.probe_events)
    print(f"serving/speedup/tenants{probe['tenants']} full={probe['full']['events_per_s']} "
          f"incremental={probe['incremental']['events_per_s']} events/s, "
          f"speedup={probe['speedup']}x", flush=True)
    print(json.dumps({"serving_load": dict(
        config=dict(tenants=tenant_counts, arrivals=list(ARRIVALS),
                    strategies=list(STRATEGY_LABELS.values()), rate=args.rate,
                    device=args.device),
        rows=rows, speedup=probe)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
