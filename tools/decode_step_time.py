"""Wall ms of chatglm3-6b's decode step, and of one ``flash_decode`` call,
in source trees of the port, paired on one card.

    python3 tools/decode_step_time.py --src PARENT/src --src src

In each tree: chatglm3-6b at full size (random bf16 weights, seed 0), a
64-token prompt of 4 requests through the cache (``prefill_into_cache``),
then 32 greedy decode steps from position 64, timed as ``chip_smoke.py``'s
serve phase times them (host clock around the steps, one synchronize
after the last), five times from the same position; and ``flash_decode``
alone at the last step's shape (B 4, 96 positions, 32 query heads, 2 KV
heads, hd 128, the split route), 500 calls back to back, one synchronize
after the last (wall ms a call: the device takes about 0.01 ms of it, so
this is the wrapper's host cost). Trees run in the order given and then in reverse (A, B, B, A), each
in a fresh interpreter. Prints one JSON line per tree run and, last, each
(tree, metric)'s median. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

STEPS, REPEATS, CALLS = 32, 5, 500

CHILD = r"""
import hashlib, json, sys, time
import numpy as np
import torch
sys.path.insert(0, SRC)
from repro_torch.configs.registry import get_config
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch.serve import prefill_into_cache
from repro_torch.models.transformer import init_params
from repro_torch.serve.decode import make_serve_step

dev = torch.device("cuda")
cfg = get_config("chatglm3-6b")
params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
rng = np.random.default_rng(0)
B, P = 4, 64
prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)), device=dev)
serve = make_serve_step(cfg)
row = {"src": SRC}
with torch.inference_mode():
    last, cache = prefill_into_cache(params, cfg, prompt, P + STEPS)
    torch.cuda.synchronize()
    step_ms = []
    for r in range(REPEATS):
        toks = [last]
        w0 = time.perf_counter()
        for i in range(STEPS):
            nxt, _, cache = serve(params, cache, toks[-1][:, None], P + i)
            toks.append(nxt)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - w0) * 1e3 / STEPS)
        if r == 0:
            row["tokens"] = hashlib.sha256(torch.stack(toks, 1).cpu().numpy().tobytes()).hexdigest()[:16]
    row["step_ms"] = sorted(step_ms)[len(step_ms) // 2]
    row["step_ms_all"] = step_ms

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16).to(dev)

    L = P + STEPS
    q, k, v = draw((B, 32, 128)), draw((B, L, 2, 128)), draw((B, L, 2, 128))
    if fd.decode_route(q, k, v) != "split":
        raise SystemExit("the serving step's shape left the split route")
    call_ms = []
    for _ in range(3):
        for _ in range(20):
            fd.flash_decode(q, k, v, L)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for _ in range(CALLS):
            fd.flash_decode(q, k, v, L)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - w0) * 1e3 / CALLS)
    row["flash_decode_call_ms"] = sorted(call_ms)[1]
print(json.dumps(row), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src directory (give it once per tree)")
    args = ap.parse_args()
    srcs = [str(Path(s).resolve()) for s in args.src]
    rows = []
    for src in srcs + srcs[::-1]:
        code = f"SRC = {src!r}\nSTEPS, REPEATS, CALLS = {STEPS}, {REPEATS}, {CALLS}\n" + CHILD
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
        for key in ("step_ms", "flash_decode_call_ms"):
            summary.setdefault(f"{r['src']} {key}", []).append(r[key])
    tokens = {r["tokens"] for r in rows}
    print(json.dumps({**{k: statistics.median(v) for k, v in summary.items()},
                      "same_tokens": len(tokens) == 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
