"""Host time of one surrogate group by part: what ``run_batch`` does for a
group of the paper-figure sweep, timed from outside.

    python3 tools/episode_host.py [--graphs cholesky,lu,qr] [--nt 16] [--reps 5]
        [--device cuda]

Builds the figure sweep of ``chip_smoke.py``'s episode phase for each
graph (tile 512, ``paper_machine(1..8)`` x the five figure specs x 30
seeds, noise 0.03: 1 200 configurations, one group) and runs
``run_batch`` on it ``--reps`` times after a warm-up. ``run_batch`` is not
changed: the functions it calls are wrapped in place with clocks (host
``perf_counter``), and the wrapper around the kernel's launch
synchronizes the card when it returns, so the parts of one call are
consecutive:

  grouping     entry into run_batch until it asks for the plan (graph
               lookups, the group keys);
  plan         ``build_plan`` (memoized with the graph after the warm-up);
  config_batch the batch axes: machine rows, strategy parsing, noise rows;
  inputs       ``episode_inputs``: the batch's arrays copied to the device
               one by one (the plan's tensors are made once per device);
  tables       ``episode_tables``: the plan's order and task records on the
               device (built with the plan's tensors, once per device);
  checks       ``episode_scan``'s argument checks (one read of the ids'
               extremes, a sync on the card);
  kernel       the launch until the device has finished;
  copy_back    the results copied to the host, into arrays;
  results      one ``BatchResult`` a configuration, in input order.

Prints one JSON line per graph and run, each part's median ms and share
of the wall, and, for the instrumentation's cost, the median wall of the
same ``run_batch`` without the clocks. Needs a CUDA device unless
``--device cpu`` (a rehearsal: then ``kernel`` is the plain scan).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SPECS = ("heft", "ws", "dada?alpha=0", "dada?alpha=0.5", "dada?alpha=0.5&use_cp=1")
PARTS = ("grouping", "plan", "config_batch", "inputs", "tables", "checks", "kernel", "copy_back",
         "results")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graphs", default="cholesky,lu,qr")
    ap.add_argument("--nt", type=int, default=16, help="tiles per side")
    ap.add_argument("--runs", type=int, default=30, help="seeds a (GPU count, spec)")
    ap.add_argument("--reps", type=int, default=5, help="timed run_batch calls a graph")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import api, cached_graph
    from repro_torch.core import episode as ep
    from repro_torch.kernels import sched_episode as se
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.linalg.lu import lu_graph
    from repro_torch.linalg.qr import qr_graph

    cuda = args.device != "cpu"
    if cuda and not torch.cuda.is_available():
        print("episode_host: no CUDA device available", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    builders = {"cholesky": cholesky_graph, "lu": lu_graph, "qr": qr_graph}
    machines = {n: paper_machine(n) for n in range(1, 9)}

    stamps = {}

    def clocked(fn, enter, leave, after=None):
        def inner(*a, **kw):
            stamps.setdefault(enter, time.perf_counter())
            out = fn(*a, **kw)
            if after is not None:
                after()
            stamps[leave] = time.perf_counter()
            return out
        return inner

    originals = (ep.build_plan, ep.config_batch, ep.episode_inputs, ep.episode_scan,
                 se._launch, ep.run_episodes)

    def instrument(on: bool) -> None:
        if not on:
            (ep.build_plan, ep.config_batch, ep.episode_inputs, ep.episode_scan,
             se._launch, ep.run_episodes) = originals
            return
        ep.build_plan = clocked(originals[0], "plan_in", "plan_out")
        ep.config_batch = clocked(originals[1], "batch_in", "batch_out")
        ep.episode_inputs = clocked(originals[2], "inputs_in", "inputs_out")
        ep.episode_scan = clocked(originals[3], "scan_in", "scan_out", after=sync)
        se._launch = clocked(originals[4], "launch_in", "launch_out")
        ep.run_episodes = clocked(originals[5], "episodes_in", "episodes_out")

    def split(t0: float, t1: float) -> dict:
        s = stamps
        kernel_in = s.get("launch_in", s["scan_in"])  # the CPU has no launch
        edges = (t0, s["plan_in"], s["plan_out"], s["batch_out"], s["inputs_out"], s["scan_in"],
                 kernel_in, s["scan_out"], s["episodes_out"], t1)
        return {p: (b - a) * 1e3 for p, a, b in zip(PARTS, edges, edges[1:])}

    summary = []
    for gname in args.graphs.split(","):
        g = cached_graph(partial(builders[gname], args.nt, 512, with_fns=False))
        items = [{"graph": g, "machine": machines[n], "strategy": s, "seed": 1234 + i,
                  "noise": 0.03} for n in machines for s in SPECS for i in range(args.runs)]
        ref = api.run_batch(items, device=args.device)  # warm-up: plan built, kernel loaded
        sync()
        walls, plain_walls, parts = [], [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            api.run_batch(items, device=args.device)
            sync()
            plain_walls.append((time.perf_counter() - t0) * 1e3)
            instrument(True)
            stamps.clear()
            try:
                t0 = time.perf_counter()
                got = api.run_batch(items, device=args.device)
                sync()
                t1 = time.perf_counter()
            finally:
                instrument(False)
            if got != ref:
                raise SystemExit(f"{gname}: results differ between runs")
            walls.append((t1 - t0) * 1e3)
            parts.append(split(t0, t1))
            print(json.dumps(dict(graph=gname, nt=args.nt, configs=len(items), wall_ms=walls[-1],
                                  plain_wall_ms=plain_walls[-1], parts_ms=parts[-1])), flush=True)
        wall = statistics.median(walls)
        med = {p: statistics.median(r[p] for r in parts) for p in PARTS}
        row = dict(graph=gname, nt=args.nt, configs=len(items), device=args.device,
                   device_name=torch.cuda.get_device_name(0) if cuda else "cpu",
                   reps=args.reps, median_wall_ms=wall,
                   median_plain_wall_ms=statistics.median(plain_walls), median_ms=med,
                   share={p: med[p] / wall for p in PARTS})
        summary.append(row)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
