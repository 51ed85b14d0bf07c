"""What a broken Mamba decode path does to the hybrid's prefill-against-cache gap.

    PYTHONPATH=src python3 tools/hybrid_fault_gap.py                  # the card, full width
    PYTHONPATH=src python3 tools/hybrid_fault_gap.py --device cpu --width 256

``chip_smoke.py``'s hybrid phase serves jamba-v0.1-52b (16 of its 32
layers, random bf16 weights, seed 0) and holds the prefill's logits at the
64th prompt token against the cache path's (63 tokens filled by decode
steps, the 64th run as one more step), every expert routed, within
``HYBRID_LOGIT_TOL``. This tool runs that comparison with the phase's
weights, prompt and config (``compare_cfg``), once sound and once for each
fault planted in the decode step's Mamba state. The faults are patched in
around ``mamba_apply`` at run time (``chip_smoke.frozen``); the port's code
is not changed:

  * ``ssm``: every step's ssm update is undone (the state never advances);
  * ``conv``: every step's conv window is put back (it never shifts);
  * ``both``.

A tolerance that tells a sound path from a broken one lies between the
sound gap and the smallest fault's. Prints one JSON line a run (the gap,
max |prefill - cache path| over the largest |logit|, and the argmax
agreement of the 4 rows) and, on the card, its name and power limit.
``--width`` cuts d_model, the dense ff and the expert ff to that width (the
heads, head dim, pattern, Mamba state and experts kept) for a quick run on
the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (HYBRID_ARCH, HYBRID_LAYERS, HYBRID_LOGIT_TOL, SERVE_B,  # noqa: E402
                        SERVE_PREFILL, SERVE_PROMPT, SERVE_STEPS, compare_cfg, frozen,
                        patched)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch.serve import prefill_into_cache  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve.decode import make_prefill_step, make_serve_step  # noqa: E402

FAULTS = {"sound": (), "ssm": ("ssm",), "conv": ("conv",), "both": ("ssm", "conv")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = get_config(HYBRID_ARCH).scaled(n_layers=HYBRID_LAYERS)
    if args.width is not None:
        w = args.width
        cfg = cfg.scaled(d_model=w, d_ff=2 * w, moe=dataclasses.replace(cfg.moe, d_ff=2 * w))
    check_cfg = compare_cfg(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)  # the phase's draws: the long prompt, then the prompt
    rng.integers(0, cfg.vocab, (SERVE_B, SERVE_PREFILL))
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (SERVE_B, SERVE_PROMPT)), device=dev)
    rows = {}
    with torch.inference_mode():
        a = make_prefill_step(check_cfg)(params, {"tokens": prompt})[:, 0]
        for name, keys in FAULTS.items():
            with patched([(mamba_mod, "mamba_apply", frozen(keys))]):
                _, cache = prefill_into_cache(params, check_cfg, prompt[:, :-1],
                                              SERVE_PROMPT + SERVE_STEPS)
                _, b, _ = make_serve_step(check_cfg)(params, cache, prompt[:, -1:],
                                                     SERVE_PROMPT - 1)
            b = b[:, 0]
            rows[name] = dict(fault=name, gap=((a - b).abs().max() / a.abs().max()).item(),
                              argmax_agree=int((a.argmax(-1) == b.argmax(-1)).sum()),
                              max_logit=a.abs().max().item(), d_model=cfg.d_model,
                              layers=cfg.n_layers, dtype=cfg.compute_dtype, tol=HYBRID_LOGIT_TOL)
            print(json.dumps(rows[name]), flush=True)
            del cache
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
              .strip(), flush=True)
    faults = min(r["gap"] for k, r in rows.items() if k != "sound")
    print(f"sound gap {rows['sound']['gap']:.6f}; smallest fault gap {faults:.6f}; "
          f"HYBRID_LOGIT_TOL {HYBRID_LOGIT_TOL} between them: "
          f"{rows['sound']['gap'] < HYBRID_LOGIT_TOL < faults}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
