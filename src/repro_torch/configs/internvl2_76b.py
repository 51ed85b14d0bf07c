"""internvl2-76b [vlm]: 80L d8192 64H (GQA kv=8) ff28672 vocab128256 —
InternLM2-76B language backbone; InternViT patch embeddings STUBBED
(input_specs provides precomputed patch embeddings).
[arXiv:2404.16821; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    act="silu", rope_style="full",
    frontend_tokens=256, frontend_dim=3200,  # InternViT-6B width stub
    param_dtype="bfloat16",
)
