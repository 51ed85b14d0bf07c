"""xlstm-1.3b [ssm]: 48L d2048 4H vocab50304, sLSTM + mLSTM blocks in a
7:1 ratio (xLSTM[7:1]); no separate FFN (d_ff=0 per spec — cells carry
their own up/down projections). [arXiv:2405.04517; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=512,
    act="gelu", rope_style="none",
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm",
                   "mlstm", "mlstm", "mlstm", "slstm"),
    subquadratic=True, tie_embeddings=True,
)
