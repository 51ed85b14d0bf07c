"""Serving entry point: prefill a batch of requests, then decode tokens.

``python -m repro_torch.launch.serve --arch chatglm3-6b`` (on the card;
``--arch minicpm3-4b`` serves the MLA model the same way);
``--smoke --device cpu`` runs the reduced config on the CPU, where the
attention kernels take their plain versions.

The MoE models and the attention / Mamba hybrid run with ``--smoke``
(``--arch grok-1-314b --smoke``, ``--arch kimi-k2-1t-a32b --smoke``,
``--arch jamba-v0.1-52b --smoke``, on the CPU or the card). Their full
configs do not fit one card (633 GB, 2.08 TB and 103 GB of bf16 weights),
and the CLI has no depth flag, as the reference's has none:
``chip_smoke.py`` serves them at full width on one card with the depth
cut (grok-1 at 4 of its 64 layers, kimi-k2 at 1 of its 61, jamba at 16 of
its 32) through the same entry points.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, get_config, smoke_config
from ..device import resolve_device
from ..models.transformer import cache_init, init_params
from ..serve.decode import make_serve_step


def prefill_into_cache(params, cfg, tokens, cache_len):
    """Run the prompt through decode steps to fill the cache (the
    reference's simple path; a Mamba layer's state advances token by token).
    Returns the greedy next token and the cache."""
    B, S = tokens.shape
    cache = cache_init(cfg, B, cache_len, tokens.device)
    serve = make_serve_step(cfg)
    last = None
    for i in range(S):
        last, _, cache = serve(params, cache, tokens[:, i : i + 1], i)
    return last, cache


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="chatglm3-6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    B = args.batch
    cache_len = args.prompt_len + args.tokens
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(B, args.prompt_len)), dtype=torch.int64, device=dev
    )

    t0 = time.time()
    with torch.inference_mode():
        last_tok, cache = prefill_into_cache(params, cfg, prompt, cache_len)
        _sync(dev)
        print(f"prefill {args.prompt_len} tokens x {B} reqs: {time.time()-t0:.2f}s")

        serve = make_serve_step(cfg)
        out = [last_tok]
        t0 = time.time()
        for i in range(args.tokens - 1):
            nxt, _, cache = serve(params, cache, out[-1][:, None], args.prompt_len + i)
            out.append(nxt)
        _sync(dev)
    dt = time.time() - t0
    toks = torch.stack(out, dim=1)
    print(f"decoded {args.tokens-1} steps x {B} reqs in {dt:.2f}s "
          f"({B*(args.tokens-1)/max(dt,1e-9):.1f} tok/s) on {dev}")
    print("sample:", toks[0, :12].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
