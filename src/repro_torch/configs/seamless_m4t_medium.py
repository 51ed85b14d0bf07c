"""seamless-m4t-medium [audio]: 12L enc + 12L dec, d1024 16H ff4096
vocab256206, encoder-decoder; audio frontend STUBBED (input_specs provides
precomputed frame embeddings). [arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64,
    act="gelu", norm="layernorm", rope_style="full",
    frontend_tokens=1024, frontend_dim=160,  # fbank-frame stub width
)
