"""Architecture registry: ``--arch <id>`` -> ModelConfig (+ smoke variants)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from .base import MLAConfig, ModelConfig, MoEConfig

_MODULES = {
    "chatglm3-6b": "chatglm3_6b",
    "gemma-7b": "gemma_7b",
    "granite-8b": "granite_8b",
    "minicpm3-4b": "minicpm3_4b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "grok-1-314b": "grok_1_314b",
    "xlstm-1.3b": "xlstm_1p3b",
    "internvl2-76b": "internvl2_76b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: one pattern period (or
    two tiny layers), narrow width, few experts, tiny vocab/frontend."""
    cfg = get_config(arch)
    over: Dict = dict(
        n_layers=cfg.period * (1 if cfg.period > 1 else 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab=512,
        remat=False,
        max_seq=512,
    )
    if cfg.moe is not None:
        over["moe"] = MoEConfig(
            n_experts=4, top_k=min(2, cfg.moe.top_k), d_ff=64, every=cfg.moe.every
        )
    if cfg.mla is not None:
        over["mla"] = MLAConfig(
            q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=16,
            v_head_dim=32,
        )
    if cfg.enc_layers:
        over["enc_layers"] = 2
    if cfg.frontend_tokens:
        over["frontend_tokens"] = 8
        over["frontend_dim"] = 48
    over["param_dtype"] = "float32"
    return cfg.scaled(**over)
