"""How far apart the MoE serving path's two ways to the same logits are.

    PYTHONPATH=src python3 tools/moe_logit_gap.py [--device cpu] [--widths 256,512]

For grok-1-314b (4 layers), kimi-k2-1t-a32b (1 layer) and the hybrid
jamba-v0.1-52b (16 layers: 14 Mamba, 2 attention, 8 MoE) at reduced widths
(d_model and the dense and expert ff cut to each of ``--widths`` and twice
that; the heads, head dim, block pattern, Mamba state, experts and top-k of
the published configs kept; vocab 4 096) with random bf16 weights (seed 0)
and the capacity factor that drops nothing (E / K), it runs a 4 x 64 prompt
through the prefill and through ``prefill_into_cache`` plus one decode step
at the last position, as ``chip_smoke.py``'s moe and hybrid phases do at
full width (the hybrid fills the first 63 tokens and runs the 64th as that
step: a Mamba state cannot take a token twice), and prints

  * the gap, max |prefill - decode path| over the largest |logit| of the
    last position, in bf16 and in f32;
  * the tokens (of the 4 x 64, per MoE layer) whose top-k expert set
    differs between the two paths.

The hybrid runs twice: at its published top-2, where one bf16 ulp flips a
token's experts, and through the recurrence of the Mamba layers every later
token of its sequence moves, so the two paths' logits part by far more than
rounding; and with every expert routed (top-k 16 at capacity factor 1),
where nothing discrete is left and the gap is rounding alone, as
``chip_smoke.py``'s hybrid phase compares them.

``chip_smoke.py`` takes ``MOE_LOGIT_TOL`` from these numbers;
``HYBRID_LOGIT_TOL`` comes from the hybrid's full-width readings on the card,
sound and with planted faults (``tools/hybrid_fault_gap.py``).
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

from chip_smoke import (HYBRID_ARCH, HYBRID_LAYERS, MOE_ARCHS, patched,  # noqa: E402
                        route_flips, routing_probe)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch.serve import prefill_into_cache  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.transformer import _is_moe_position, init_params  # noqa: E402
from repro_torch.serve.decode import make_prefill_step, make_serve_step  # noqa: E402

B, PROMPT = 4, 64


def gap_run(cfg, dev):
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (B, PROMPT)),
                             device=dev)
    record = []
    n_fill = PROMPT - 1 if "mamba" in cfg.block_pattern else PROMPT
    with torch.inference_mode(), patched([(moe_mod, "moe_apply", routing_probe(moe_mod, record))]):
        a = make_prefill_step(cfg)(params, {"tokens": prompt})[:, 0]
        n_pre = len(record)
        _, cache = prefill_into_cache(params, cfg, prompt[:, :n_fill], PROMPT + 1)
        _, b, _ = make_serve_step(cfg)(params, cache, prompt[:, -1:], PROMPT - 1)
    n_moe = sum(_is_moe_position(cfg, i % cfg.period) for i in range(cfg.n_layers))
    flips, _ = route_flips(record, n_pre, n_moe, PROMPT)
    gap = ((a - b[:, 0]).abs().max() / a.abs().max()).item()
    return gap, sum(flips), a.abs().max().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--widths", default="256,512")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    rows = []
    runs = [(arch, layers, False) for arch, layers in MOE_ARCHS]
    runs += [(HYBRID_ARCH, HYBRID_LAYERS, False), (HYBRID_ARCH, HYBRID_LAYERS, True)]
    for arch, layers, every_expert in runs:
        full = get_config(arch)
        for w in (int(x) for x in args.widths.split(",")):
            # the factor that drops nothing, E / K; or every expert routed (the
            # hybrid's check: top-k E at factor 1, so no route can flip)
            moe = dataclasses.replace(full.moe, d_ff=2 * w,
                                      capacity_factor=full.moe.n_experts / full.moe.top_k)
            if every_expert:
                moe = dataclasses.replace(moe, top_k=full.moe.n_experts, capacity_factor=1.0)
            for dtype in ("bfloat16", "float32"):
                cfg = full.scaled(n_layers=layers, d_model=w, d_ff=2 * w, vocab=4096, moe=moe,
                                  compute_dtype=dtype, max_seq=512)
                gap, flips, top = gap_run(cfg, dev)
                row = dict(arch=arch, layers=layers, d_model=w, expert_ff=2 * w, dtype=dtype,
                           top_k=moe.top_k, capacity_factor=moe.capacity_factor,
                           gap=gap, route_flips=flips,
                           tokens=B * PROMPT * sum(_is_moe_position(cfg, i % cfg.period)
                                                   for i in range(layers)),
                           max_logit=top)
                rows.append(row)
                print(json.dumps(row), flush=True)
    for label, keep in (("MoE", lambda r: r["arch"] != HYBRID_ARCH),
                        ("hybrid, top-k as published", lambda r: r["arch"] == HYBRID_ARCH
                         and r["capacity_factor"] > 1),
                        ("hybrid, every expert routed", lambda r: r["arch"] == HYBRID_ARCH
                         and r["capacity_factor"] == 1.0)):
        worst = max(r["gap"] for r in rows if r["dtype"] == "bfloat16" and keep(r))
        print(f"largest bf16 gap ({label}) {worst:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
