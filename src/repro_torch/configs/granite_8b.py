"""granite-8b [dense]: 36L d4096 32H (GQA kv=8) ff14336 vocab49152,
llama-arch code model. [arXiv:2405.04324; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152, head_dim=128,
    act="silu", rope_style="full",
)
