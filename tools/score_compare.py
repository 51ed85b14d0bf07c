"""Scheduling wall time and scoring time of source trees of the port,
paired on one card.

    python3 tools/score_compare.py --src PARENT/src --src src \
        [--runs cholesky:16,qr:16,lu:16,cholesky:64] [--device cuda --device cpu]

Runs the simulations of ``--runs`` (default ``RUNS`` below) once per
tree, in the order given and then in reverse (A, B, B, A), each tree in a fresh interpreter so that two
versions of ``repro_torch`` never meet in one process. Every run is HEFT
or DADA(0.5)+CP on ``paper_machine(8)`` with every activation scored
(``min_wide=1``), on the card and with ``device="cpu"`` (``--device``
picks). Prints one JSON
line per run (tree, graph, NT, strategy, device, wall s, score s, scored
activations, score ms per activation, the longest call, the seconds the
garbage collector paused the run and the part of them inside scoring
calls, makespan) and, last, each tree's
median per (graph, NT, strategy, device). "score" is the backend call
of one activation: ``place_heft`` / ``place_dada`` (scoring and placement)
on trees that have them, ``score_matrices`` on older ones. Fails unless
every run of a (graph, NT, strategy) gives the same makespan. Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

RUNS = [("cholesky", 16), ("qr", 16), ("lu", 16), ("cholesky", 64)]
SPECS = ("heft", "dada?alpha=0.5&use_cp=1")

CHILD = r"""
import gc, json, sys, time
import torch
sys.path.insert(0, SRC)
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import Simulator
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.linalg.lu import lu_graph
from repro_torch.linalg.qr import qr_graph
from repro_torch.sched import resolve

builders = {"cholesky": cholesky_graph, "lu": lu_graph, "qr": qr_graph}
machine = paper_machine(8)


gc_pause = [0.0, 0.0]  # seconds in the garbage collector; start of the current pass


def on_gc(phase, info):
    if phase == "start":
        gc_pause[1] = time.perf_counter()
    else:
        gc_pause[0] += time.perf_counter() - gc_pause[1]


gc.callbacks.append(on_gc)


def run(gname, nt, spec, device):
    strategy = resolve(spec, device=device)
    # the backend call of one activation: scoring and placement on trees
    # that place on the device, scoring alone before them
    be = strategy.backend
    method = "place_heft" if spec == "heft" else "place_dada"
    method = method if hasattr(be, method) else "score_matrices"
    score = getattr(be, method)
    acc = [0, 0.0, 0.0, 0.0]  # calls, seconds, the longest call, gc seconds inside calls

    def timed(*args, **kwargs):
        s0, g0 = time.perf_counter(), gc_pause[0]
        out = score(*args, **kwargs)
        dt = time.perf_counter() - s0
        acc[0] += 1
        acc[1] += dt
        acc[2] = max(acc[2], dt)
        acc[3] += gc_pause[0] - g0
        return out

    setattr(be, method, timed)
    sim = Simulator(builders[gname](nt, 512), machine, strategy, seed=0)
    g0 = gc_pause[0]
    w0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    return dict(src=SRC, graph=gname, nt=nt, strategy=res.strategy, device=device, call=method,
                wall_s=time.perf_counter() - w0, score_s=acc[1], scored=acc[0],
                score_ms_per_act=acc[1] / acc[0] * 1e3, max_call_ms=acc[2] * 1e3,
                gc_s=gc_pause[0] - g0, gc_in_score_s=acc[3], makespan=res.makespan)


for device in DEVICES:  # warm-up: kernel build, first-use costs
    run("cholesky", 4, SPECS[1], device)
for gname, nt in RUNS:
    for spec in SPECS:
        for device in DEVICES:
            print(json.dumps(run(gname, nt, spec, device)), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src directory (repeat; run in order, then reversed)")
    ap.add_argument("--runs", default=",".join(f"{g}:{nt}" for g, nt in RUNS),
                    help="graph:NT pairs, comma-separated")
    ap.add_argument("--device", action="append", choices=("cuda", "cpu"),
                    help="devices to run on (repeat; default both)")
    args = ap.parse_args()
    runs = [(g, int(nt)) for g, nt in (r.split(":") for r in args.runs.split(","))]
    devices = tuple(args.device or ("cuda", "cpu"))
    import torch

    if not torch.cuda.is_available():
        print("score_compare: no CUDA device available", file=sys.stderr)
        return 2
    srcs = [str(Path(s).resolve()) for s in args.src]
    rows = []
    for src in srcs + srcs[::-1]:
        code = (f"SRC = {src!r}\nRUNS = {runs!r}\nSPECS = {SPECS!r}\nDEVICES = {devices!r}\n"
                + CHILD)
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             check=False)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            print(line, flush=True)
            rows.append(json.loads(line))
    keys = sorted({(r["graph"], r["nt"], r["strategy"], r["device"]) for r in rows})
    for key in keys:  # every tree, run and device gives the same schedule
        same = {r["makespan"] for r in rows if (r["graph"], r["nt"], r["strategy"]) == key[:3]}
        if len(same) != 1:
            raise SystemExit(f"{key}: makespans differ between runs: {same}")
    for src in dict.fromkeys(srcs):  # each tree once, however often it ran
        for key in keys:
            mine = [r for r in rows if r["src"] == src and
                    (r["graph"], r["nt"], r["strategy"], r["device"]) == key]
            print(json.dumps(dict(
                src=src, graph=key[0], nt=key[1], strategy=key[2], device=key[3], runs=len(mine),
                median_wall_s=statistics.median(r["wall_s"] for r in mine),
                median_score_ms_per_act=statistics.median(r["score_ms_per_act"] for r in mine),
                median_gc_in_score_s=statistics.median(r["gc_in_score_s"] for r in mine),
                makespan=mine[0]["makespan"],
            )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
