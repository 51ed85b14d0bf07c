"""Serving: prefill and single-token decode steps.

Counterpart of ``repro/serve/decode.py`` for the served decoder-only
configs: the attention-only transformers (GQA and MLA attention, dense and
MoE alike) and the attention / Mamba hybrid, whose cache holds each Mamba
layer's ``ssm`` and ``conv`` state beside the attention layers' K/V (the
encoder-decoder cross cache waits for that family, ``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..models.transformer import cache_init, check_supported, forward


def make_prefill_step(cfg: ModelConfig, moe_chunks: int = 1):
    """Prefill returns last-position logits only, (B, 1, V) f32: serving only
    ever samples from the final position. ``moe_chunks`` goes to every MoE
    layer's dispatch."""
    check_supported(cfg)

    def prefill_step(params, batch):
        logits, _, _ = forward(params, cfg, batch["tokens"], last_logit_only=True,
                               moe_chunks=moe_chunks)
        return logits

    return prefill_step


def make_decode_cache(cfg: ModelConfig, B: int, S: int, device="cuda") -> Dict:
    """Allocate the zero cache (B sequences of S positions)."""
    return cache_init(cfg, B, S, device)


def make_serve_step(cfg: ModelConfig, moe_chunks: int = 1):
    """``serve_step(params, cache, tokens, pos) -> (next_token, logits, cache)``:
    one decode step at the int position ``pos``; the cache (K/V and Mamba
    states) is updated in place; the next token is the greedy argmax (int32). ``moe_chunks`` goes
    to every MoE layer's dispatch."""
    check_supported(cfg)

    def serve_step(params, cache, tokens, pos):
        logits, cache, _ = forward(params, cfg, tokens, cache=cache, cache_pos=pos,
                                   moe_chunks=moe_chunks)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, logits, cache

    return serve_step
