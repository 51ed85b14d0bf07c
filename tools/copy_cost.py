"""Host cost of the two ways to issue a placement call's copies, on the card.

    python3 tools/copy_cost.py [--blocks 8] [--reps 300]

Times whole ``place_dada`` and ``place_heft`` calls at n 128 (LU NT 64 on
``paper_machine(8)``, every third datum moved to a GPU: the activation of
``chip_smoke.py``'s place phase) with the copy in and the copy out of
``TorchScoringBackend._place`` issued two ways on the same staging
buffers: ``tensor``, ``Tensor.copy_(non_blocking=True)`` on slices (what
the backend does), and ``pointer``, ``cudaMemcpyAsync`` on raw pointers
through a C entry that this script builds with the package's ``nvcc``
flags into ``build/tools/``. Everything else in the call (packing, both
launches, the one synchronisation, the read back) is the same. Blocks of
``--reps`` calls alternate pointer, tensor, tensor, pointer, ...; prints
one JSON line with each way's per-block ms per call, their medians and
the card's name and power limit. Both ways must return the same
placement.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

# the pointer way's one C entry
COPY_SRC = r"""
#include <cuda_runtime.h>
extern "C" int copy_async(void* dst, const void* src, long long bytes, int to_device,
                          void* stream) {
  return static_cast<int>(cudaMemcpyAsync(
      dst, src, static_cast<size_t>(bytes),
      to_device ? cudaMemcpyHostToDevice : cudaMemcpyDeviceToHost,
      static_cast<cudaStream_t>(stream)));
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--reps", type=int, default=300)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("copy_cost: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.configs.paper_machine import paper_machine
    from repro_torch.core import Simulator
    from repro_torch.kernels._build import BUILD_DIR, build_library
    from repro_torch.kernels.sched_place import launch_placement, read_placement
    from repro_torch.kernels.sched_score import launch_score
    from repro_torch.linalg.lu import lu_graph
    from repro_torch.sched import resolve

    src = BUILD_DIR.parent / "tools" / "copy_async.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(COPY_SRC)
    lib, _ = build_library(src)
    lib.copy_async.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                                        ctypes.c_void_p]
    lib.copy_async.restype = ctypes.c_int

    def copy(dst, src, nbytes, to_device, stream):
        if lib.copy_async(dst, src, nbytes, int(to_device), stream) != 0:
            raise RuntimeError("cudaMemcpyAsync failed")

    def pointer_place(be, layout, packed, machine):
        """``TorchScoringBackend._place`` with pointer-level copies."""
        n_scores, n_placed = layout.score.n_out, layout.n_out
        stream = torch.cuda.current_stream(be.device)
        index, handle = be.device.index or 0, stream.cuda_stream
        in_ptr, out_ptr = be._dev_in.data_ptr(), be._dev_out.data_ptr()
        copy(in_ptr, packed.data_ptr(), 8 * layout.n_in, True, handle)
        launch_score(in_ptr, machine.data_ptr(), out_ptr, layout.score, index, handle)
        launch_placement(in_ptr, out_ptr, out_ptr + 8 * n_scores, layout, index, handle)
        copy(be._host_out.data_ptr(), out_ptr + 8 * n_scores, 8 * n_placed, False, handle)
        stream.synchronize()
        return read_placement(be._host_out_np[:n_placed].view(np.int64), layout)

    machine = paper_machine(8)
    sim = Simulator(lu_graph(64, 512), machine, resolve("heft", device="cpu"), seed=0)
    for k, name in enumerate(sim.arrays.data_names):
        if k % 3 == 0:
            sim.residency.write(name, k % 8)
        elif k % 3 == 1:
            sim.residency.add_copy(name, (k + 1) % 8)
    tids = list(range(128))
    res = machine.resources
    out = {}
    for spec in ("dada?alpha=0.5&use_cp=1", "heft"):
        strategy = resolve(spec)
        be = strategy.backend
        if spec == "heft":
            method, kw = be.place_heft, strategy.preamble(sim, tids)
        else:
            p_cpu, p_gpu, section = strategy.preamble(sim, tids)
            method = be.place_dada
            kw = dict(p_cpu=p_cpu, p_gpu=p_gpu, use_cp=True, affinity="accel_write",
                      area_bound=False, **section)
        ms = {"pointer": [], "tensor": []}
        got = {}
        for b in range(2 * args.blocks):
            way = ("pointer", "tensor", "tensor", "pointer")[b % 4]
            if way == "pointer":
                be._place = types.MethodType(pointer_place, be)
            for _ in range(20):
                got[way] = method(sim, tids, res, **kw)
            w0 = time.perf_counter()
            for _ in range(args.reps):
                method(sim, tids, res, **kw)
            ms[way].append((time.perf_counter() - w0) / args.reps * 1e3)
            be.__dict__.pop("_place", None)
        if got["pointer"] != got["tensor"]:
            raise SystemExit(f"{spec}: the two ways place differently")
        out[method.__name__] = dict(
            ms_per_call=ms, median_ms={w: statistics.median(v) for w, v in ms.items()})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(card=smi, n=len(tids), n_res=len(res), reps=args.reps, calls=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
