"""grok-1-314b [moe]: 64L d6144 48H (GQA kv=8) ff32768 vocab131072,
MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, head_dim=128,
    act="silu", rope_style="full",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32768, every=1),
    param_dtype="bfloat16",
)
