"""Where the time of one serving run goes, by the serving pool's parts.

    python3 tools/serving_round.py [--tenants 1024] [--arrival poisson]
        [--spec heft] [--rescore incremental] [--device cuda] [--reps 3]

Runs ``run_serving`` (serving_load's configuration: arrivals at 2 000 a
simulated second from seed 7, ``paper_machine(4)``, seed 0) ``--reps``
times in this interpreter after one untimed run, with host clocks around
the serving pool's parts, and on the card CUDA events around each
``score_activation`` call:

  * ``gather_s``: ``score_pool``'s host loop over the dirty rows' reads,
    masks and static durations, and its layout lookup;
  * ``pack_s``: ``pack_activation`` writing them into the pinned buffer;
  * ``score_s``: ``_score``: on the card one copy in, the launch, one
    copy back and the synchronisation (the plain version on the CPU);
  * ``launch_span_s``: the device span between CUDA events recorded just
    before and just after each ``score_activation`` call: the kernel and
    the device's wait for the host to submit it (the kernel alone is
    timed by ``chip_smoke.py``'s kernel phase);
  * ``unpack_s``: the output views;
  * ``rows_s``: the rest of ``_rebuild``: pressure rows, the rows' lists,
    the heap pushes;
  * ``engine_s``: the rest of ``run_serving``: building and submitting
    the tenants' graphs, events, transfers, assignment from the heap,
    the report (the baselines are cached by the untimed run).

Prints, per repetition and as medians, one JSON line each with the
rounds, scored rounds, rows built, events a second and each part in
seconds and in ms a scored round, beside the card's name and power limit
(``nvidia-smi``). Exits 2 without a card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenants", type=int, default=1024)
    ap.add_argument("--arrival", default="poisson", choices=("poisson", "bursty", "diurnal"))
    ap.add_argument("--spec", default="heft")
    ap.add_argument("--rescore", default="incremental", choices=("incremental", "full"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("serving_round: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import backend as be
    from repro_torch.kernels import sched_score as ss
    from repro_torch.runtime.load import make_arrivals, run_serving
    from repro_torch.runtime.rescore import ServingScheduler

    on_card = args.device == "cuda"
    parts = {k: 0.0 for k in ("rebuild", "score_pool", "pack", "score", "unpack")}
    events = []
    counts = {"scored": 0}

    def timed(owner, name, key):
        fn = getattr(owner, name)

        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[key] += time.perf_counter() - t0

        setattr(owner, name, wrapper)

    timed(ServingScheduler, "_rebuild", "rebuild")
    timed(be.TorchScoringBackend, "score_pool", "score_pool")
    timed(be, "pack_activation", "pack")
    timed(be.TorchScoringBackend, "_score", "score")
    timed(be, "unpack_outputs", "unpack")
    launch = be.score_activation

    def evented(*a, **k):
        counts["scored"] += 1
        if not on_card:
            return launch(*a, **k)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*a, **k)
        end.record()
        events.append((start, end))
        return out

    be.score_activation = evented
    machine = paper_machine(4)
    arr = make_arrivals(args.arrival, args.tenants, rate=2000.0, seed=7)
    baselines = {}

    def run():
        return run_serving(arr, machine, args.spec, seed=0, rescore=args.rescore,
                           baselines=baselines, device=args.device)

    run()  # untimed: builds, first calls, the cached baselines
    card = "cpu"
    if on_card:
        import subprocess

        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    rows = []
    for rep in range(args.reps):
        for k in parts:
            parts[k] = 0.0
        events.clear()
        counts["scored"] = 0
        t0 = time.perf_counter()
        out = run()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        device_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
        scored = counts["scored"]
        p = dict(parts)
        split = dict(
            gather_s=p["score_pool"] - p["pack"] - p["score"] - p["unpack"],
            pack_s=p["pack"], score_s=p["score"], launch_span_s=device_s if on_card else None,
            unpack_s=p["unpack"], rows_s=p["rebuild"] - p["score_pool"],
            engine_s=wall - p["rebuild"],
        )
        row = dict(rep=rep, device=card, tenants=args.tenants, arrival=args.arrival,
                   spec=args.spec, rescore=args.rescore, wall_s=wall,
                   events=out["n_events"], events_per_s=out["n_events"] / wall,
                   rounds=out["engine"]._serving.n_rounds, scored_rounds=scored,
                   rows_built=out["rows_built"], **split,
                   ms_a_scored_round={k: (v * 1e3 / scored if v is not None and scored else None)
                                      for k, v in split.items() if k != "engine_s"},
                   launches=ss.score_activation.launches)
        rows.append(row)
        print(json.dumps(row), flush=True)
    med = {k: statistics.median(r[k] for r in rows)
           for k in ("wall_s", "events_per_s", "gather_s", "pack_s", "score_s", "unpack_s",
                     "rows_s", "engine_s") if rows}
    if on_card:
        med["launch_span_s"] = statistics.median(r["launch_span_s"] for r in rows)
    print(json.dumps({"median": med, "device": card, "reps": args.reps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
