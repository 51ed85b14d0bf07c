"""minicpm3-4b [dense/MLA]: 62L d2560 40H ff6400 vocab73448, MLA attention.
[hf:openbmb/MiniCPM3-4B]"""
from .base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448, head_dim=64,
    act="silu", rope_style="half",
    mla=MLAConfig(
        q_lora_rank=768, kv_lora_rank=256,
        qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    ),
)
