"""Where a step of the surrogate episode kernel spends its cycles, by phase.

    python3 tools/episode_clocks.py [--src src]

Copies the tree's ``src`` to ``build/episode_clocks/src`` and inserts
``clock64()`` probes into that copy of ``csrc/sched_episode.cu`` at the
phase marks of a step: the wait for the task's rows, the state loads and
the next task's copies being issued, the wait for the loads, the folds, the
score and the argmins, the advance, and the scatters. Each warp sums the
cycles of each phase over its steps and, at the end, writes the sums over
the first words of its state, which the copy's wrapper keeps. Runs the
uncapped kernel on the paper-figure sweep's Cholesky and QR NT 16 groups
(1 200 configurations) and on 40 configurations of Cholesky NT 64, and
prints one JSON line each: the mean cycles a step in every phase (lane 0's
clock). The probes cost a few cycles each; the copy is never used for
results. Fails if a phase mark is missing from the source. Needs one CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = Path("repro_torch/kernels/csrc/sched_episode.cu")
PY = Path("repro_torch/kernels/sched_episode.py")
PHASES = ("row_wait", "issue", "gather_wait", "fold", "score_argmin", "advance", "scatter",
          "step")
# (mark in the source, text put in its place); each mark occurs once
PROBES = (
    ("    const int* row = rows + (k & 1) * rw;\n    cp_wait_all();\n"
     "    __syncwarp();  // every lane's copies, and the last step's stores\n",
     "    const long long c0 = clock64();\n    const int* row = rows + (k & 1) * rw;\n"
     "    cp_wait_all();\n    __syncwarp();  // every lane's copies, and the last step's stores\n"
     "    const long long c1 = clock64();\n"),
    ("    if (lane < r_pad) masks[lane] = mv;\n",
     "    const long long c2 = clock64();\n    if (lane < r_pad) masks[lane] = mv;\n"),
    ("    __syncwarp();\n\n    // 3. the folds",
     "    __syncwarp();\n    const long long c3 = clock64();\n\n    // 3. the folds"),
    ("    // 4. the score per resource", "    const long long c4 = clock64();\n    // 4. the score per resource"),
    ("    // 5. the advance", "    const long long c5 = clock64();\n    // 5. the advance"),
    ("    __syncwarp();  // every lane has read the clocks\n",
     "    __syncwarp();  // every lane has read the clocks\n    const long long c6 = clock64();\n"),
    ("    // 6. LRU eviction",
     "    const long long c7 = clock64();\n"
     "    cyc[0] += c1 - c0; cyc[1] += c2 - c1; cyc[2] += c3 - c2; cyc[3] += c4 - c3;\n"
     "    cyc[4] += c5 - c4; cyc[5] += c6 - c5; cyc[6] += c7 - c6; cyc[7] += c7 - c0;\n"
     "    // 6. LRU eviction"),
    ("  bool patch = false;  // the last task was one of this task's predecessors\n",
     "  bool patch = false;  // the last task was one of this task's predecessors\n"
     "  long long cyc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"),
    ("    a.npl[b] = npl;\n  }\n}",
     "    a.npl[b] = npl;\n"
     "    for (int i = 0; i < 8; ++i) reinterpret_cast<long long*>(st)[i] = cyc[i];\n  }\n}"),
)
KEEP_STATE = ("    state = torch.empty(B * state_words(n_pad, nd1, n_u, use_cap), dtype=i32, device=dev)\n",
              "    state = torch.empty(B * state_words(n_pad, nd1, n_u, use_cap), dtype=i32, device=dev)\n"
              "    globals()['last_state'] = state\n")

CHILD = r"""
import json, sys
import torch
sys.path.insert(0, SRC)
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import episode as ep
from repro_torch.kernels import sched_episode as se
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.linalg.qr import qr_graph

SPECS = ("heft", "ws", "dada?alpha=0", "dada?alpha=0.5", "dada?alpha=0.5&use_cp=1")
machines = {n: paper_machine(n) for n in range(1, 9)}
dev = torch.device("cuda")
for gname, build, nt, configs in (("cholesky", cholesky_graph, 16, 1200), ("qr", qr_graph, 16, 1200),
                                  ("cholesky", cholesky_graph, 64, 40)):
    items = [{"machine": machines[n], "strategy": s, "seed": 1234 + i, "noise": 0.03}
             for i in range(30) for n in machines for s in SPECS][:configs]
    plan = ep.build_plan(build(nt, 512, with_fns=False), machines[8], n_u=9)
    args = ep.episode_inputs(plan, ep.config_batch(plan, items), dev)
    se._launch(args, ep.episode_tables(plan, dev), n_steps=plan.n, use_cap=False, emit=False)
    torch.cuda.synchronize()
    words = se.state_words(plan.n_pad, plan.n_data + 1, plan.n_u, False)
    sums = se.last_state.view(len(items), words)[:, :16].contiguous().view(torch.int64)
    per_step = (sums.double().mean(dim=0) / plan.n).tolist()
    print(json.dumps(dict(graph=gname, nt=nt, configs=len(items), steps=plan.n,
                          device=torch.cuda.get_device_name(0),
                          cycles_a_step=dict(zip(PHASES, per_step)))), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("episode_clocks: no CUDA device available", file=sys.stderr)
        return 2
    dst = ROOT / "build" / "episode_clocks" / "src"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(args.src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    text = (dst / CU).read_text()
    for mark, probe in PROBES:
        if text.count(mark) != 1:
            raise SystemExit(f"phase mark not found once in {CU}: {mark!r}")
        text = text.replace(mark, probe)
    (dst / CU).write_text(text)
    py = (dst / PY).read_text()
    if py.count(KEEP_STATE[0]) != 1:
        raise SystemExit(f"the state allocation is not where {PY} had it")
    (dst / PY).write_text(py.replace(*KEEP_STATE))
    code = f"SRC = {str(dst)!r}\nPHASES = {PHASES!r}\n" + CHILD
    return subprocess.run([sys.executable, "-c", code], check=False).returncode


if __name__ == "__main__":
    sys.exit(main())
