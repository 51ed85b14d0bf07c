"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines and its wall time; any failure exits
non-zero and no phase carries on past its own failure):

  1. build    build the CUDA kernel from the repo's sources with nvcc and
              print the card (name and power limit, from nvidia-smi);
  2. kernel   the transfer-matrix kernel against its plain PyTorch versions
              on seeded inputs (n_pad 8..256, r_pad 1..4, n_u 9/25/30, with
              empty masks, host-only masks and padded reads): the outputs
              must be exactly equal; then the kernel's and the plain
              version's times at the main path's widest shape;
  3. main     HEFT and DADA(0.5)+CP on the paper machine with 8 GPUs over
              the Cholesky, LU and QR tile DAGs at NT 16 (tile 512, the
              paper's shape) and NT 64 (the reference's scaling size), every
              activation scored on the card (min_wide=1), plus one NT 64
              Cholesky run per strategy at min_wide=32. Each run's
              (makespan, bytes, transfers, busy, intervals) must equal the
              port's own device="cpu" run, every task must run once, and
              every run must have launched the kernel;
  4. profile  one NT 16 Cholesky run per strategy under torch.profiler:
              the device's busy time (kernels and copies) against the
              run's wall time;
  5. report   a JSON line of every ported kernel, then the last line
              ``{"ok": true, "device": {...}}``.

Needs one CUDA device; exits 2 without printing a result when there is
none. Imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_FP64_FLOPS = 34e12  # H100 SXM data sheet, f64 outside the tensor cores


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(name, t0):
    print(f"== {name} done in {time.perf_counter() - t0:.3f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def full_case(rng, n_pad, r_pad, n_u):
    """Seeded full residency masks: n_u 9 and 30 have the host as column 0
    (paper machines), n_u 25 has no host column (an all-GPU machine)."""
    if n_u == 25:
        shifts, host = list(range(1, n_u + 1)), [False] * n_u
    else:
        shifts, host = list(range(n_u)), [True] + [False] * (n_u - 1)
    bits = np.asarray(sorted({0, *shifts}), dtype=np.int64)
    pick = rng.random((n_pad, r_pad, len(bits))) < 0.3
    masks = (pick * (np.int64(1) << bits)).sum(axis=2).astype(np.int64)
    per_read = rng.random((n_pad, r_pad)) * 1e-3
    per_read[rng.random((n_pad, r_pad)) < 0.1] = 0.0
    masks[0] = 0  # data that exists nowhere
    if n_pad > 1:
        masks[1] = 1  # host-only copies
    pad = rng.random(n_pad) < 0.5
    pad[:2] = False
    masks[pad, r_pad - 1] = 0  # padded reads
    per_read[pad, r_pad - 1] = 0.0
    return masks, per_read, np.asarray(shifts, dtype=np.int64), np.asarray(host, dtype=bool)


def time_ms(fn, reps=200):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=100):
    """Device time of ``fn``'s kernels alone: ``reps`` calls captured in
    one CUDA graph and replayed, so no host launch cost is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (10 * reps)


def fingerprint(res):
    return (
        res.makespan, res.total_bytes, res.n_transfers,
        tuple(sorted(res.busy.items())),
        tuple((iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals),
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.kernels import sched_score as ss
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.linalg.lu import lu_graph
    from repro_torch.linalg.qr import qr_graph
    from repro_torch.sched import resolve

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 1. build ----------------------------------------------------------
    t0 = phase("build")
    card = card_line()
    print(card)
    report = ss.build()
    for line in report.splitlines():
        print(f"  {line.strip()}")
    done("build", t0)

    # ---- 2. kernel against its plain versions ------------------------------
    t0 = phase("kernel")
    rng = np.random.default_rng(0)
    max_err = 0.0
    n_cases = 0
    for n_pad in (8, 64, 128, 256):
        for r_pad in (1, 2, 4):
            for n_u in (9, 25, 30):
                host_args = [torch.from_numpy(a) for a in full_case(rng, n_pad, r_pad, n_u)]
                masks, per_read, shift, host = [a.to(dev) for a in host_args]
                got = ss.transfer_matrix(masks, per_read, shift, host)
                plain_full = ss.transfer_matrix_from_full(masks, per_read, shift, host)
                col_bits = torch.tensor([1 << (u + 1) for u in range(n_u)], dtype=torch.int32, device=dev)
                plain_compact = ss.transfer_matrix_compact(
                    ss.compact_masks(masks, shift), per_read, col_bits, host
                )
                plain_cpu = ss.transfer_matrix_from_full(*host_args)
                torch.cuda.synchronize()
                g = got.cpu()
                if got.shape != (n_pad, n_u) or not torch.isfinite(g).all():
                    raise SystemExit(f"kernel output malformed at {(n_pad, r_pad, n_u)}")
                for want in (plain_full.cpu(), plain_compact.cpu(), plain_cpu):
                    if not torch.equal(g, want):
                        raise SystemExit(
                            f"kernel disagrees with its plain version at n_pad={n_pad} "
                            f"r_pad={r_pad} n_u={n_u}: max |diff| "
                            f"{(g - want).abs().max().item()}"
                        )
                max_err = max(max_err, (g - plain_cpu).abs().max().item())
                n_cases += 1
    print(f"kernel exactly equal to both plain versions on {n_cases} cases (max |err| {max_err})")
    # the main path's widest shape: n_pad 128 (LU NT 64), r_pad 4, n_u 9
    shape = (128, 4, 9)
    masks, per_read, shift, host = [
        torch.from_numpy(a).to(dev) for a in full_case(np.random.default_rng(1), *shape)
    ]
    kernel_ms = time_ms(lambda: ss.transfer_matrix(masks, per_read, shift, host))
    plain_ms = time_ms(lambda: ss.transfer_matrix_from_full(masks, per_read, shift, host))
    device_ms = graph_ms(lambda: ss.transfer_matrix(masks, per_read, shift, host))
    n, r, n_u = shape
    nbytes = n * r * 8 * 2 + n_u * (8 + 1) + n * n_u * 8
    flops = 2 * n * r * n_u
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP64_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(
        f"transfer_matrix at n_pad={n} r_pad={r} n_u={n_u}: kernel {kernel_ms:.6f} ms "
        f"per call ({device_ms:.6f} ms on the device, from a CUDA graph), "
        f"plain {plain_ms:.6f} ms, bound {bound_ms:.3e} ms ({nbytes} bytes, {flops} flop)"
    )
    done("kernel", t0)

    # ---- 3. main path -------------------------------------------------------
    t0 = phase("main")
    builders = {"cholesky": cholesky_graph, "lu": lu_graph, "qr": qr_graph}
    specs = ("heft", "dada?alpha=0.5&use_cp=1")
    runs = [(g, nt, s, 1) for nt in (16, 64) for g in builders for s in specs]
    runs += [("cholesky", 64, s, 32) for s in specs]
    machine = paper_machine(8)
    total_launches = 0
    for gname, nt, spec, min_wide in runs:
        results = {}
        for device in ("cuda", "cpu"):
            graph = builders[gname](nt, 512)
            strategy = resolve(spec, device=device, min_wide=min_wide)
            # activations and host time spent scoring, counted here only
            activations = [0]
            score_s = [0.0]
            place = strategy.place
            score = strategy.backend.score_matrices

            def counted(sim, ready, src, place=place, activations=activations):
                activations[0] += 1
                place(sim, ready, src)

            def timed(*args, score=score, score_s=score_s, **kwargs):
                s0 = time.perf_counter()
                out = score(*args, **kwargs)
                score_s[0] += time.perf_counter() - s0
                return out

            strategy.place = counted
            strategy.backend.score_matrices = timed
            sim = Simulator(graph, machine, strategy, seed=0)
            ss.transfer_matrix.launches = 0
            w0 = time.perf_counter()
            res = sim.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
            launches = ss.transfer_matrix.launches
            results[device] = (res, activations[0], launches, wall, score_s[0])
        res, acts, launches, wall, score_wall = results["cuda"]
        cpu_res, cpu_acts, cpu_launches, cpu_wall, cpu_score = results["cpu"]
        n_tasks = len(builders[gname](nt, 512))
        print(
            f"run graph={gname} NT={nt} strategy={res.strategy} min_wide={min_wide} "
            f"tasks={n_tasks} activations={acts} launches={launches} "
            f"makespan={res.makespan!r} total_bytes={res.total_bytes} "
            f"wall_s={wall:.3f} score_s={score_wall:.3f} "
            f"cpu_wall_s={cpu_wall:.3f} cpu_score_s={cpu_score:.3f}",
            flush=True,
        )
        if sorted(iv.tid for iv in res.intervals) != list(range(n_tasks)):
            raise SystemExit("not every task ran exactly once")
        if not (math.isfinite(res.makespan) and res.makespan > 0 and res.total_bytes > 0):
            raise SystemExit("makespan or bytes out of range")
        if fingerprint(res) != fingerprint(cpu_res) or acts != cpu_acts:
            raise SystemExit(f"{gname} NT={nt} {spec}: card run differs from the CPU run")
        if cpu_launches != 0:
            raise SystemExit("the CPU run launched the kernel")
        if launches == 0:
            raise SystemExit(f"{gname} NT={nt} {spec}: no kernel launch on the main path")
        total_launches += launches
    done("main", t0)

    # ---- 4. profile ---------------------------------------------------------
    t0 = phase("profile")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for spec in specs:
        for _ in range(2):  # the first run warms the profiler up; the last is read
            sim = Simulator(cholesky_graph(16, 512), machine, resolve(spec), seed=0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                w0 = time.perf_counter()
                res = sim.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - w0
        busy_us = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
        )
        print(
            f"profile graph=cholesky NT=16 strategy={res.strategy} wall_s={wall:.3f} "
            f"device_busy_s={busy_us / 1e6:.6f} device_idle_share="
            f"{1.0 - busy_us / 1e6 / wall:.4f}",
            flush=True,
        )
    done("profile", t0)

    # ---- 5. report ----------------------------------------------------------
    kernels = [{
        "name": "transfer_matrix",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sched_score.cu",
        "replaces": "src/repro/kernels/sched_score.py:121",
        "launches": total_launches,
        "exact": max_err == 0.0,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": list(shape),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
