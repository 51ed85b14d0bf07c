"""Where the host time of one scheduling simulation goes, by cProfile.

    python3 tools/place_profile.py [--src SRC] [--graph qr] [--nt 64]
        [--spec 'dada?alpha=0.5&use_cp=1'] [--device cuda]

Runs the simulation twice in this interpreter (HEFT or DADA on
``paper_machine(8)``, every activation scored, ``min_wide=1``): once
plain, for its wall time, and once under ``cProfile``. Splits the
profiled run's time into

  * ``device_call_s``: the backend calls that score (and, where the tree
    has them, place) an activation — ``score_matrices``, ``place_dada``,
    ``place_heft``;
  * ``search_s``: the host λ search and EFT scan — ``try_build`` and the
    plain placement versions, outside the backend calls;
  * ``preamble_s``: the rest of the strategies' ``place`` (predictions,
    sort keys, the preference scan, the bisection driver);
  * ``engine_s``: everything outside ``place``;

and prints them as one JSON line, with the fifteen functions of largest
own time. ``--src`` picks the source tree (a parent checkout's ``src``
to compare two trees on one card). cProfile slows Python code about
twofold, so the split is read as shares of the profiled run.
"""
from __future__ import annotations

import argparse
import cProfile
import gc
import json
import pstats
import sys
import time
from pathlib import Path

DEVICE_CALLS = ("score_matrices", "place_dada", "place_heft")
SEARCH = ("try_build", "dada_place_plain", "heft_select_plain")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--graph", default="qr", choices=("cholesky", "lu", "qr"))
    ap.add_argument("--nt", type=int, default=64)
    ap.add_argument("--spec", default="dada?alpha=0.5&use_cp=1")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("place_profile: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.linalg.lu import lu_graph
    from repro_torch.linalg.qr import qr_graph
    from repro_torch.sched import resolve

    build = {"cholesky": cholesky_graph, "lu": lu_graph, "qr": qr_graph}[args.graph]

    def run(strategy, prof=None, nt=args.nt):
        sim = Simulator(build(nt, 512), paper_machine(8), strategy, seed=0)
        gc.collect()
        if prof is not None:
            prof.enable()
        w0 = time.perf_counter()
        res = sim.run()
        if args.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        if prof is not None:
            prof.disable()
        return res, wall

    run(resolve(args.spec, device=args.device), nt=4)  # warm-up: kernel build, first-use costs
    res, wall = run(resolve(args.spec, device=args.device))
    prof = cProfile.Profile()
    res_p, wall_p = run(resolve(args.spec, device=args.device), prof)
    if res_p.makespan != res.makespan:
        raise SystemExit("the profiled run's schedule differs")
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (cc, nc, own, cumulative, callers)

    place = sum(v[3] for (f, _, name), v in stats.items()
                if name == "place" and (f.endswith("core/dada.py") or f.endswith("core/heft.py")))
    device_call = sum(v[3] for (f, _, name), v in stats.items()
                      if name in DEVICE_CALLS and f.endswith("core/backend.py"))
    # the search as the strategies call it themselves (on trees that place
    # on the device, the CPU backend calls the plain versions inside its
    # device call: those calls count there)
    search = sum(ct for (f, _, name), v in stats.items() if name in SEARCH
                 for (cf, _, _), (_, _, _, ct) in v[4].items()
                 if cf.endswith(("core/dada.py", "core/heft.py")))
    own = sorted(((v[2], f"{Path(f).name}:{line}:{name}", v[1]) for (f, line, name), v in stats.items()),
                 reverse=True)[:15]
    print(json.dumps(dict(
        src=args.src, graph=args.graph, nt=args.nt, strategy=res.strategy, device=args.device,
        wall_s=wall, profiled_wall_s=wall_p, place_s=place, device_call_s=device_call,
        search_s=search, preamble_s=place - device_call - search, engine_s=wall_p - place,
        top_own_s=[dict(function=name, own_s=t, calls=c) for t, name, c in own],
        makespan=res.makespan,
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
