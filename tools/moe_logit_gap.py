"""How far apart the MoE serving path's two ways to the same logits are.

    PYTHONPATH=src python3 tools/moe_logit_gap.py [--device cpu] [--widths 256,512]

For grok-1-314b (4 layers) and kimi-k2-1t-a32b (1 layer) at reduced widths
(d_model and the expert ff cut to each of ``--widths`` and twice that; the
heads, head dim, experts and top-k of the published configs kept; vocab
4 096) with random bf16 weights (seed 0) and the capacity factor that
drops nothing (E / K), it runs a 4 x 64 prompt through the prefill and
through ``prefill_into_cache`` plus one decode step at the last position,
as ``chip_smoke.py``'s moe phase does at full width, and prints

  * the gap, max |prefill - decode path| over the largest |logit| of the
    last position, in bf16 and in f32;
  * the tokens (of the 4 x 64, per layer) whose top-k expert set differs
    between the two paths.

``chip_smoke.py`` takes its tolerance for the full-width gap from these
numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import MOE_ARCHS, patched, route_flips, routing_probe  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch.serve import prefill_into_cache  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve.decode import make_prefill_step, make_serve_step  # noqa: E402

B, PROMPT = 4, 64


def gap_run(cfg, dev):
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (B, PROMPT)),
                             device=dev)
    record = []
    with torch.inference_mode(), patched([(moe_mod, "moe_apply", routing_probe(moe_mod, record))]):
        a = make_prefill_step(cfg)(params, {"tokens": prompt})[:, 0]
        n_pre = len(record)
        _, cache = prefill_into_cache(params, cfg, prompt, PROMPT + 1)
        _, b, _ = make_serve_step(cfg)(params, cache, prompt[:, -1:], PROMPT - 1)
    flips, _ = route_flips(record, n_pre, cfg.n_layers, PROMPT)
    gap = ((a - b[:, 0]).abs().max() / a.abs().max()).item()
    return gap, sum(flips), a.abs().max().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--widths", default="256,512")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    rows = []
    for arch, layers in MOE_ARCHS:
        full = get_config(arch)
        for w in (int(x) for x in args.widths.split(",")):
            moe = dataclasses.replace(full.moe, d_ff=2 * w,
                                      capacity_factor=full.moe.n_experts / full.moe.top_k)
            for dtype in ("bfloat16", "float32"):
                cfg = full.scaled(n_layers=layers, d_model=w, d_ff=2 * w, vocab=4096, moe=moe,
                                  compute_dtype=dtype, max_seq=512)
                gap, flips, top = gap_run(cfg, dev)
                row = dict(arch=arch, layers=layers, d_model=w, expert_ff=2 * w, dtype=dtype,
                           gap=gap, route_flips=flips, tokens=B * PROMPT * layers,
                           max_logit=top)
                rows.append(row)
                print(json.dumps(row), flush=True)
    worst = max(r["gap"] for r in rows if r["dtype"] == "bfloat16")
    print(f"largest bf16 gap {worst:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
