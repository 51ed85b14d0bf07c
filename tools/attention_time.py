"""Device time of ``flash_attention`` at the serving prefills' shapes in
source trees of the port, paired on one card.

    python3 tools/attention_time.py --src PARENT/src --src src

Shapes (B 4, S 2048, bf16, causal, the model's (B, S, H, d) projections as
(B, H, S, d) views): chatglm3-6b (32 query heads, 2 KV heads, d 128), the
same at d 64, and minicpm3-4b's MLA (40 heads, query/key head dim 96, value
head dim 64), the last only in trees whose ``flash_attention`` takes a
value head dim of its own (whose argument check accepts v narrower than
k). Each call is timed as ``--reps`` launches captured in one CUDA graph
and replayed five times (device ms a launch).
Trees run in the order given and then in reverse (A, B, B, A), each in a
fresh interpreter so that two versions of ``repro_torch`` never meet in one
process. With ``--copies N`` each shape is also timed on N - 1 copies of
its inputs in fresh device memory; with ``--ballast-gib G`` each run first
holds G GiB of device memory (what a long-running process such as
``chip_smoke.py`` holds by the time it times attention). Prints one JSON line per tree run and,
last, each (tree, shape)'s median device ms (and the least and most over
the copies). Fails unless every tree gives the same outputs. Needs one
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
from repro_torch.kernels import flash_attention as fa

dev = torch.device("cuda")
rng = np.random.default_rng(3)
# device memory held for the whole run, in 1 GiB blocks, before any input
ballast = [torch.ones(1 << 29, dtype=torch.bfloat16, device=dev) for _ in range(BALLAST_GIB)]


def takes_dv():
    # a tree without a value head dim of its own refuses v narrower than k
    q = torch.zeros(1, 1, 32)
    try:
        fa._check(q, q, q[..., :16], True)
    except ValueError:
        return False
    return True


takes_dv = takes_dv()


def draw(shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16).to(dev)


def graph_ms(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


row = {"src": SRC}
for label, (hq, hk, dk, dv) in (("chatglm3-6b", (32, 2, 128, 128)), ("d64", (32, 2, 64, 64)),
                                ("minicpm3-4b", (40, 40, 96, 64))):
    if dv != dk and not takes_dv:
        continue
    q = draw((4, 2048, hq, dk)).transpose(1, 2)
    k = draw((4, 2048, hk, dk)).transpose(1, 2)
    v = draw((4, 2048, hk, dv)).transpose(1, 2)
    if fa.attention_route(q, k, v) != "tc":
        raise SystemExit(f"{label}: not on the tensor-core route")
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    row[label] = graph_ms(lambda: fa.flash_attention(q, k, v))
    row[label + "_out"] = hashlib.sha256(out.contiguous().cpu().view(torch.int16).numpy().tobytes()).hexdigest()[:16]
    # the same inputs copied to fresh device memory, the earlier copies kept
    # alive: what the operands' placement alone moves
    kept, times = [], [row[label]]
    for _ in range(COPIES - 1):
        q, k, v = (t.transpose(1, 2).clone().transpose(1, 2) for t in (q, k, v))
        kept.append((q, k, v))
        times.append(graph_ms(lambda: fa.flash_attention(q, k, v)))
    row[label + "_copies"] = times
print(json.dumps(row), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src directory (give it once per tree)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--copies", type=int, default=1,
                    help="also time each shape on this many copies of its inputs in all")
    ap.add_argument("--ballast-gib", type=int, default=0,
                    help="GiB of device memory each run holds before it draws its inputs")
    args = ap.parse_args()
    srcs = [str(Path(s).resolve()) for s in args.src]
    rows = []
    for src in srcs + srcs[::-1]:
        code = (f"SRC = {src!r}\nREPS = {args.reps}\nCOPIES = {args.copies}\n"
                f"BALLAST_GIB = {args.ballast_gib}\n" + CHILD)
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rows.append(json.loads(line))
    outs = {}
    for r in rows:
        for key, value in r.items():
            if key.endswith("_out"):
                outs.setdefault(key, set()).add(value)
    if any(len(v) != 1 for v in outs.values()):
        print(f"the trees' outputs differ: {outs}", file=sys.stderr)
        return 1
    summary, spread = {}, {}
    for r in rows:
        for key, value in r.items():
            if key.endswith("_copies"):
                spread.setdefault(f"{r['src']} {key}", []).extend(value)
            elif key not in ("src",) and not key.endswith("_out"):
                summary.setdefault(f"{r['src']} {key}", []).append(value)
    print(json.dumps({**{k: statistics.median(v) for k, v in summary.items()},
                      **{k: [min(v), max(v)] for k, v in spread.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
