"""jamba-v0.1-52b [hybrid]: 32L d4096 32H (GQA kv=8) ff14336 vocab65536,
Mamba:attention 7:1 interleave, MoE 16e top-2 every other layer.
[arXiv:2403.19887; hf]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    act="silu", rope_style="none",  # Jamba uses no positional encoding
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, every=2),
    mamba_d_state=16, mamba_expand=2, mamba_d_conv=4,
    subquadratic=True,
)
