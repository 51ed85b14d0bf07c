"""gemma-7b [dense]: 28L d3072 16H (kv=16) ff24576 vocab256000, GeGLU,
head_dim=256, tied embeddings. [arXiv:2403.08295; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    d_ff=24576, vocab=256000, head_dim=256,
    act="geglu", rope_style="full", tie_embeddings=True,
)
