"""Device time of the placement kernels (``dada_place``, ``heft_select``) in
source trees of the port, paired on one card.

    python3 tools/place_time.py --src PARENT/src --src src [--widths 8,32,128,512]

For each width n, the activation of ``chip_smoke.py``'s place phase: the
first n tasks of LU NT 64 (tile 512) on ``paper_machine(8)``, with residency
spread over the memories as there, packed by the strategy's own backend and
preamble (DADA(0.5)+CP, HEFT), scored once by ``score_activation``. Each
kernel is timed alone: ``--reps`` launches captured in one CUDA graph and
replayed (device ms a launch), and ``--reps`` launches back to back between
CUDA events (ms a launch, the wrapper's Python included). Trees run in the
order given and then in reverse (A, B, B, A), each in a fresh interpreter
so that two versions of ``repro_torch`` never meet in one process. Prints
one JSON line per (tree, kernel, width) and, last, each one's median device
ms. Fails unless every tree gives the same placement buffers. Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import hashlib, json, sys
import numpy as np
import torch
sys.path.insert(0, SRC)
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import Simulator
from repro_torch.kernels import sched_place as sp
from repro_torch.kernels import sched_score as ss
from repro_torch.linalg.lu import lu_graph
from repro_torch.sched import resolve

dev = torch.device("cuda")
machine = paper_machine(8)
sim = Simulator(lu_graph(64, 512), machine, resolve("dada?alpha=0.5&use_cp=1"), seed=0)
for k, name in enumerate(sim.arrays.data_names):
    if k % 3 == 0:
        sim.residency.write(name, k % 8)
    elif k % 3 == 1:
        sim.residency.add_copy(name, (k + 1) % 8)


def graph_ms(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * REPS)


def event_ms(fn):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


res = machine.resources
for n in WIDTHS:
    tids = list(range(n))
    for name, spec in (("dada_place", "dada?alpha=0.5&use_cp=1"), ("heft_select", "heft")):
        strategy = resolve(spec)
        if name == "dada_place":
            p_cpu, p_gpu, section = strategy.preamble(sim, tids)
            pspec = sp.PlaceSpec("dada", n, len(res), n_cpu=len(machine.cpus),
                                 n_gpu=len(machine.gpus))
            layout, packed, mach = strategy.backend.pack(
                sim, tids, res, place=pspec, p_cpu=p_cpu, p_gpu=p_gpu, use_cp=True,
                affinity="accel_write")
            sp.pack_dada(packed.numpy(), layout, tids=tids, **section)
        else:
            scan = strategy.preamble(sim, tids)
            pspec = sp.PlaceSpec("heft", n, len(res), n_cls=len(scan["durations"]))
            layout, packed, mach = strategy.backend.pack(sim, tids, res, place=pspec, use_cp=True,
                                                         x_rows=True)
            sp.pack_heft(packed.numpy(), layout, **scan)
        kernel = getattr(sp, name)
        d_in = packed.clone().to(dev)
        d_scores = ss.score_activation(d_in[:layout.score.n_in], layout.score, mach)
        d_out = torch.empty(layout.n_out, dtype=torch.int64, device=dev)
        fn = lambda: kernel(d_in, d_scores, layout, out=d_out)
        device_ms = graph_ms(fn)
        ms = event_ms(fn)
        out = d_out.cpu().numpy()
        got = sp.read_placement(out, layout)
        print(json.dumps(dict(src=SRC, kernel=name, n=n, n_res=len(res), reps=REPS,
                              device_ms=device_ms, ms=ms, iters=getattr(got, "iters", None),
                              placement=hashlib.sha256(out.tobytes()).hexdigest()[:16])),
              flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src directory (give it once per tree)")
    ap.add_argument("--widths", default="8,32,128,512")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()
    widths = [int(w) for w in args.widths.split(",")]
    srcs = [str(Path(s).resolve()) for s in args.src]
    order = srcs + srcs[::-1]
    rows = []
    for src in order:
        code = f"SRC = {src!r}\nWIDTHS = {widths!r}\nREPS = {args.reps}\n" + CHILD
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rows.append(json.loads(line))
    by_key = {}
    for r in rows:
        by_key.setdefault((r["kernel"], r["n"]), set()).add(r["placement"])
    if any(len(v) != 1 for v in by_key.values()):
        print(f"the trees' placements differ: {by_key}", file=sys.stderr)
        return 1
    summary = {}
    for r in rows:
        summary.setdefault(f"{r['src']} {r['kernel']} n={r['n']}", []).append(r["device_ms"])
    print(json.dumps({k: statistics.median(v) for k, v in summary.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
