"""What building a strategy per run costs in ``run_many``.

    PYTHONPATH=src python3 tools/strategy_construction.py [--runs 3] [--gpus 8] [--device cuda]

``run_many`` builds a fresh strategy for every seed, and so for HEFT and
DADA a fresh scoring backend (its pinned staging buffer and the machine
buffer on the card). This times fig2's configuration (Cholesky NT 16, tile
512, ``paper_machine(--gpus)``) for HEFT and DADA(0.5)+CP in two ways: a
fresh strategy per run, and one strategy object reused across the seeds,
in the order fresh, shared, shared, fresh (A B B A). Then the constructor
alone, 100 times. Prints the card's name and power limit, one line per
spec, and last a JSON object of the seconds a run, the constructor's ms
and whether both ways gave the same summary. Exits 1 when they differ.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from functools import partial

import torch

from repro_torch.bench import common
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import run_many

SPECS = ("heft", "dada?alpha=0.5&use_cp=1")


def card_line(device: str) -> str:
    if device != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def measure(spec: str, n_runs: int, n_gpus: int, device: str) -> dict:
    graph = common.graphs_for()["cholesky"]
    machine = paper_machine(n_gpus)
    shared = common.strategy_for(spec, device)
    factories = {"fresh": partial(common.strategy_for, spec, device), "shared": lambda: shared}
    walls, summaries = {"fresh": [], "shared": []}, {}
    for label in ("fresh", "shared", "shared", "fresh"):
        w0 = time.perf_counter()
        summaries[label] = run_many(graph, machine, factories[label], n_runs=n_runs)
        sync(device)
        walls[label].append((time.perf_counter() - w0) / n_runs)
    w0 = time.perf_counter()
    for _ in range(100):
        common.strategy_for(spec, device)
    sync(device)
    build_ms = (time.perf_counter() - w0) * 1000 / 100
    return dict(fresh_s_per_run=walls["fresh"], shared_s_per_run=walls["shared"],
                constructor_ms=build_ms, same_summary=summaries["fresh"] == summaries["shared"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=common.FAST_RUNS)
    ap.add_argument("--gpus", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    card = card_line(args.device)
    print(card, flush=True)
    out = {}
    for spec in SPECS:
        out[spec] = measure(spec, args.runs, args.gpus, args.device)
        m = out[spec]
        print(f"{spec}: s a run fresh {m['fresh_s_per_run']} shared {m['shared_s_per_run']}; "
              f"constructor alone {m['constructor_ms']} ms; same summaries {m['same_summary']}",
              flush=True)
    print(json.dumps({"card": card, "runs": args.runs, "gpus": args.gpus, "device": args.device,
                      "construction": out}))
    return 0 if all(m["same_summary"] for m in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
