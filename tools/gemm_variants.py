"""Development timings of the gemm_update kernel on one NVIDIA GPU.

    python3 tools/gemm_variants.py

Two sweeps that chip_smoke.py does not repeat on every run, at the linalg
path's three shapes (syrk / gemm 512^3 with trans_b, ssssm 512^3, tsmqr
1024 x 512 x 1024), in device ms from CUDA-graph replays:

  1. splits: f32, the planner's tile with k cut into 1, 2, 4 and 8 splits,
     beside the planner's own count;
  2. copy unit: on 16-byte-aligned operands the kernel as it is runs its
     specialisation for aligned operands (every copy 16 bytes, no branch
     on the copy unit). It is set against a build of the same source that
     never picks the specialisation, so aligned operands take the general
     kernel (the copy unit of each operand a kernel argument, uniform for
     the call). f32 and bf16, timed in the order as-is, general, general,
     as-is, twice; the two outputs must be equal bit for bit.

Prints one line per measurement, the card's name and power limit, and a
last JSON line with every number.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import card_line, graph_ms  # noqa: E402
from repro_torch.kernels import tile_gemm as tg  # noqa: E402
from repro_torch.kernels._build import BUILD_DIR, build_library  # noqa: E402

SHAPES = [("syrk/gemm", 512, 512, 512, True), ("ssssm", 512, 512, 512, False),
          ("tsmqr", 1024, 512, 1024, False)]
# the line of the host launcher that picks the aligned specialisation
PICK_ALIGNED = "const bool aligned = ua == 16 && ub == 16;"


def general_library():
    """The kernel source with the aligned specialisation never picked,
    built beside the package's libraries and bound like the package's own."""
    text = tg._SRC.read_text()
    if text.count(PICK_ALIGNED) != 1:
        raise SystemExit("tile_gemm.cu no longer has the line this script rewrites")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / "tile_gemm_general.cu"
    src.write_text(text.replace(PICK_ALIGNED, "const bool aligned = false;"))
    lib, _ = build_library(src)
    lib.repro_gemm_update.argtypes = tg._lib.repro_gemm_update.argtypes
    lib.repro_gemm_update.restype = tg._lib.repro_gemm_update.restype
    return lib


def operands(rng, m, n, k, trans_b, dtype):
    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype).cuda()
    return draw((m, n)), draw((m, k)), draw((n, k) if trans_b else (k, n))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    tg.build()
    as_is, general = tg._lib, general_library()
    rng = np.random.default_rng(2)
    result = {"card": card_line(), "splits": [], "copy_unit": []}
    for label, m, n, k, trans_b in SHAPES:
        c, a, b = operands(rng, m, n, k, trans_b, torch.float32)
        plan = tg.gemm_plan(m, n, k)
        by_split = {}
        for n_split in (1, 2, 4, 8):
            other = (plan[0], plan[1], n_split, tg.split_chunk(k, n_split))
            by_split[n_split] = graph_ms(
                lambda: tg._launch(c, a, b, alpha=-1.0, trans_b=trans_b, plan=other))
        result["splits"].append({"label": label, "shape": [m, n, k], "planner_n_split": plan[2],
                                 "device_ms_by_n_split": by_split})
        print(f"splits {label} (m,n,k)={(m, n, k)} f32: planner {plan[2]}; device ms {by_split}",
              flush=True)
    for label, m, n, k, trans_b in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            c, a, b = operands(rng, m, n, k, trans_b, dtype)
            plan = tg.gemm_plan(m, n, k)
            outs, times = {}, {"as_is": [], "general": []}

            def call():
                return tg._launch(c, a, b, alpha=-1.0, trans_b=trans_b, plan=plan)
            for name in ("as_is", "general", "general", "as_is") * 2:
                tg._lib = as_is if name == "as_is" else general
                outs[name] = call()
                times[name].append(graph_ms(call))
            tg._lib = as_is
            if not torch.equal(outs["as_is"], outs["general"]):
                raise SystemExit(f"copy unit {label} {dtype}: the two builds differ")
            row = {"label": label, "shape": [m, n, k], "dtype": str(dtype).replace("torch.", ""),
                   "device_ms": times,
                   "mean_ms": {key: sum(v) / len(v) for key, v in times.items()}}
            result["copy_unit"].append(row)
            print(f"copy unit {label} (m,n,k)={(m, n, k)} {row['dtype']}: device ms {times}; "
                  f"means {row['mean_ms']}", flush=True)
    print(result["card"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
