"""Device time of the f32 selective scan (``repro_selective_scan``) built from
several CUDA sources, paired on one card; optionally their inner loops'
instructions from ``cuobjdump -sass``.

    git show 097fb27:src/repro_torch/kernels/csrc/selective_scan.cu > build/scan_parent.cu
    python3 tools/scan_time.py --cu build/scan_parent.cu \
        --cu src/repro_torch/kernels/csrc/selective_scan.cu --sass

Each source must export ``repro_selective_scan`` with ``selective_scan``'s
C interface (f32 dt, x, B, C, A, h0 in; y, hT out). Each is built with the
package's own flags (``repro_torch/kernels/_build.py``, one ``nvcc`` each,
started together) and timed at jamba's prefill (B 4, S 2048, din 8 192, N
16, h0 zeros) and decode step (S 1, a normal h0), on
``tests/_scan_cases.py``'s inputs: ``--reps`` launches captured in one CUDA
graph and replayed five times (device ms a launch). Sources run in the
order given and then in reverse (A, B, B, A), each in a fresh interpreter.
Each run also holds its outputs against the plain scan
(``selective_scan_plain``) within 1e-5 of their largest magnitude, and
fails otherwise. Prints one JSON line per run, the card's name and power
limit, and last each (source, shape)'s median device ms.

``--sass`` also disassembles each library: for each kernel, its instruction
count and, for each backward branch (a loop), the instructions between its
target and the branch and the MUFU (special-function) ones among them; the
listings go to ``build/scan_sass/``. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import ctypes, json, sys
import torch
sys.path.insert(0, ROOT + "/src")
sys.path.insert(0, ROOT + "/tests")
from _scan_cases import scan_inputs
from repro_torch.kernels.selective_scan import selective_scan_plain

lib = ctypes.CDLL(LIB)
fn = lib.repro_selective_scan
fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
fn.restype = ctypes.c_int
dev = torch.device("cuda")


def launch(args, y, hT):
    dt, x, B, C, A, h0 = args
    err = fn(dt.data_ptr(), x.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(), h0.data_ptr(),
             y.data_ptr(), hT.data_ptr(), dt.shape[0], dt.shape[1], dt.shape[2], A.shape[1],
             dev.index or 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed: CUDA error {err}")


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


row = {"cu": CU}
for label, S, h0_zero in (("prefill", 2048, True), ("decode", 1, False)):
    args = scan_inputs(4, S, 8192, 16, 7, dev, h0_zero)
    y, hT = torch.empty_like(args[0]), torch.empty_like(args[5])
    launch(args, y, hT)
    torch.cuda.synchronize()
    want = selective_scan_plain(*args)
    err = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip((y, hT), want))
    if not err <= 1e-5:
        raise SystemExit(f"{CU} {label}: {err} from the plain scan")
    row[label] = graph_ms(lambda: launch(args, y, hT))
    row[label + "_rel_err"] = err
print(json.dumps(row), flush=True)
"""

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def sass_loops(lib: Path, out_dir: Path):
    """Per kernel of ``lib``: instructions, and each loop (a backward
    branch): its first and last address, instructions and MUFU ones."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{lib.stem}.sass").write_text(text)
    kernels = {}
    for part in text.split("Function : ")[1:]:
        name = part.splitlines()[0].strip()
        instrs, labels, pending = [], {}, []
        for line in part.splitlines()[1:]:
            m = LABEL.match(line)
            if m:
                pending.append(m.group(1))
                continue
            m = INSTR.search(line)
            if m:
                addr = int(m.group(1), 16)
                for lab in pending:
                    labels[lab] = addr
                pending = []
                instrs.append((addr, m.group(2).strip()))
        loops = []
        for addr, op in instrs:
            if not any(t.startswith("BRA") for t in op.split()[:2]):
                continue
            tgt = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", op.split("BRA", 1)[1])
            if tgt is None:
                continue
            target = labels.get(tgt.group(1)) if tgt.group(1) else int(tgt.group(2), 16)
            if target is None or target > addr:
                continue
            body = [o for a, o in instrs if target <= a <= addr]
            loops.append(dict(first=hex(target), last=hex(addr), instructions=len(body),
                              mufu=sum("MUFU" in o for o in body),
                              ex2=sum("MUFU.EX2" in o for o in body)))
        kernels[name] = dict(instructions=len(instrs), loops=loops)
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cu", action="append", required=True,
                    help="a scan source exporting repro_selective_scan (give it once per source)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sass", action="store_true", help="also count the kernels' loop instructions")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import build_library

    srcs = [Path(c).resolve() for c in args.cu]
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(build_library, srcs))
    libs = [Path(lib._name) for lib, _ in built]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for src, (_, log) in zip(srcs, built):
        used = " | ".join(line.strip() for line in log.splitlines() if "Used" in line)
        print(f"{src}: {used}", flush=True)
    if args.sass:
        out_dir = ROOT / "build" / "scan_sass"
        for src, lib in zip(srcs, libs):
            print(json.dumps({"sass": str(src), "kernels": sass_loops(lib, out_dir)}), flush=True)
    rows = []
    order = list(zip(srcs, libs))
    for src, lib in order + order[::-1]:
        code = (f"ROOT = {str(ROOT)!r}\nLIB = {str(lib)!r}\nCU = {str(src)!r}\n"
                f"REPS = {args.reps}\n" + CHILD)
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
        for key in ("prefill", "decode"):
            summary.setdefault(f"{r['cu']} {key}", []).append(r[key])
    print(json.dumps({k: statistics.median(v) for k, v in summary.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
