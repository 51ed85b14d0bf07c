"""jamba-v0.1-52b's prefill tokens/s and decode ms a step in source trees of
the port, paired on one card.

    git archive HEAD src | tar -x -C build/parent
    python3 tools/hybrid_step_time.py --src build/parent/src --src src

In each tree: jamba-v0.1-52b at 16 of its 32 layers, full width (random
bf16 weights, seed 0: 52.1 GB), as ``chip_smoke.py``'s phase hybrid serves
it: a 4 x 2048 prefill (one warm-up, then ``--prefills`` timed, host clock
around each with a synchronize; the best gives tokens/s), then a 64-token
prompt of 4 requests through the cache (``prefill_into_cache``) and 32
greedy decode steps from position 64, three times from the same cache
position (wall ms a step, the median). Trees run in the order given and
then in reverse (A, B, B, A), each in a fresh interpreter, which builds
that tree's kernels. Prints one JSON line per tree run, the card's name and
power limit, and last each (tree, metric)'s median. Needs one CUDA device
with room for the weights.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import hashlib, json, sys, time
import numpy as np
import torch
sys.path.insert(0, SRC)
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import prefill_into_cache
from repro_torch.models.transformer import init_params
from repro_torch.serve.decode import make_prefill_step, make_serve_step

dev = torch.device("cuda")
cfg = get_config("jamba-v0.1-52b").scaled(n_layers=16)
params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
rng = np.random.default_rng(0)
B, S, P, STEPS = 4, 2048, 64, 32
long_prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)
prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)), device=dev)
prefill, serve = make_prefill_step(cfg), make_serve_step(cfg)
row = {"src": SRC}
with torch.inference_mode():
    walls = []
    for i in range(PREFILLS + 1):
        w0 = time.perf_counter()
        prefill(params, {"tokens": long_prompt})
        torch.cuda.synchronize()
        if i:
            walls.append(time.perf_counter() - w0)
    row["prefill_tps"] = B * S / min(walls)
    row["prefill_walls"] = walls
    last, cache = prefill_into_cache(params, cfg, prompt, P + STEPS)
    saved = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()
             if isinstance(v, dict) and "ssm" in v}
    torch.cuda.synchronize()
    step_ms = []
    for r in range(3):
        for key, state in saved.items():  # each repeat from the same Mamba states
            for n, t in state.items():
                cache[key][n].copy_(t)
        toks = [last]
        w0 = time.perf_counter()
        for i in range(STEPS):
            nxt, _, cache = serve(params, cache, toks[-1][:, None], P + i)
            toks.append(nxt)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - w0) * 1e3 / STEPS)
        if r == 0:
            row["tokens"] = hashlib.sha256(torch.stack(toks, 1).cpu().numpy().tobytes()).hexdigest()[:16]
    row["step_ms"] = sorted(step_ms)[1]
    row["step_ms_all"] = step_ms
print(json.dumps(row), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src directory (give it once per tree)")
    ap.add_argument("--prefills", type=int, default=3)
    args = ap.parse_args()
    srcs = [str(Path(s).resolve()) for s in args.src]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    rows = []
    for src in srcs + srcs[::-1]:
        code = f"SRC = {src!r}\nPREFILLS = {args.prefills}\n" + CHILD
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rows.append(json.loads(line))
    summary = {}
    for r in rows:
        for key in ("prefill_tps", "step_ms"):
            summary.setdefault(f"{r['src']} {key}", []).append(r[key])
    print(json.dumps({k: statistics.median(v) for k, v in summary.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
