"""Device time of the surrogate episode kernel in source trees of the port,
paired on one card.

    python3 tools/episode_time.py --src PARENT/src --src src [--nt 16] [--reps 5]

Builds the paper-figure sweep of ``chip_smoke.py``'s episode phase for
Cholesky, LU and QR at ``--nt`` (tile 512, ``paper_machine(1..8)`` x the
five figure specs x 30 seeds, noise 0.03: 1 200 configurations a graph,
one group each) and times one ``episode_scan`` launch on it: CUDA events
around ``--reps`` launches back to back after a warm-up launch, the
wrapper's argument checks left out, so only the kernel is timed (a tree
whose kernel reads the plan's tables gets them built beforehand, with the
plan: variant ``tables``; an older tree's launch packs nothing: variant
``global``). Trees run in the order given and then in reverse (A, B, B, A), each in a
fresh interpreter so that two versions of ``repro_torch`` never meet in
one process. Prints one JSON line per (tree, graph, variant) and, last,
each one's median ms. Fails unless every tree and variant gives the same
makespans. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

GRAPHS = ("cholesky", "lu", "qr")

CHILD = r"""
import hashlib, inspect, json, sys
import torch
sys.path.insert(0, SRC)
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import episode as ep
from repro_torch.kernels import sched_episode as se
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.linalg.lu import lu_graph
from repro_torch.linalg.qr import qr_graph

SPECS = ("heft", "ws", "dada?alpha=0", "dada?alpha=0.5", "dada?alpha=0.5&use_cp=1")
builders = {"cholesky": cholesky_graph, "lu": lu_graph, "qr": qr_graph}
machines = {n: paper_machine(n) for n in range(1, 9)}
dev = torch.device("cuda")
if "tables" in inspect.signature(se._launch).parameters:
    variant = "tables"
else:  # a tree whose kernel scans the ready set
    variant = "global"


def time_ms(fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS, out


for gname in GRAPHS:
    g = builders[gname](NT, 512, with_fns=False)
    items = [{"machine": machines[n], "strategy": s, "seed": 1234 + i, "noise": 0.03}
             for n in machines for s in SPECS for i in range(30)]
    plan = ep.build_plan(g, machines[8], n_u=9)
    batch = ep.config_batch(plan, items)
    args = ep.episode_inputs(plan, batch, dev, len(batch))
    lead = (args, ep.episode_tables(plan, dev)) if variant == "tables" else (args,)
    ms, out = time_ms(lambda: se._launch(*lead, n_steps=plan.n, use_cap=False, emit=False))
    mk = out[0].cpu().numpy()
    assert (out[2].cpu().numpy() == plan.n).all()
    print(json.dumps(dict(src=SRC, graph=gname, nt=NT, variant=variant, configs=len(items),
                          steps=plan.n, n_pad=plan.n_pad, reps=REPS, ms=ms,
                          makespans=hashlib.sha256(mk.tobytes()).hexdigest()[:16])),
          flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src directory (repeat; run in order, then reversed)")
    ap.add_argument("--nt", type=int, default=16, help="tiles per side of the three graphs")
    ap.add_argument("--reps", type=int, default=5, help="launches timed per reading")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("episode_time: no CUDA device available", file=sys.stderr)
        return 2
    srcs = [str(Path(s).resolve()) for s in args.src]
    rows = []
    for src in srcs + srcs[::-1]:
        code = f"SRC = {src!r}\nNT = {args.nt}\nREPS = {args.reps}\nGRAPHS = {GRAPHS!r}\n" + CHILD
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             check=False)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            print(line, flush=True)
            rows.append(json.loads(line))
    for gname in GRAPHS:
        same = {r["makespans"] for r in rows if r["graph"] == gname}
        if len(same) != 1:
            raise SystemExit(f"{gname}: makespans differ between trees: {same}")
    for key in dict.fromkeys((r["src"], r["graph"], r["variant"]) for r in rows):
        mine = [r["ms"] for r in rows if (r["src"], r["graph"], r["variant"]) == key]
        print(json.dumps(dict(src=key[0], graph=key[1], nt=args.nt, variant=key[2], runs=len(mine),
                              ms=mine, median_ms=statistics.median(mine))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
