"""chatglm3-6b [dense]: 28L d4096 32H (GQA kv=2) ff13696 vocab65024, RoPE-2d.
[arXiv:2406.12793; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, head_dim=128,
    act="silu", rope_style="half", norm="rmsnorm",
)
