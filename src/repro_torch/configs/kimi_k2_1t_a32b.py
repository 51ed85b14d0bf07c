"""kimi-k2-1t-a32b [moe]: 61L d7168 64H (GQA kv=8) expert-ff2048
vocab163840, MoE 384 experts top-8 — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, head_dim=128,
    act="silu", rope_style="full",
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, every=1,
                  capacity_factor=1.25),
    param_dtype="bfloat16",  # 1T fp32 params cannot fit 512 chips
)
