"""Model/config schema for the assigned architectures.

One dataclass covers the whole pool: dense GQA transformers, MLA, MoE,
hybrid Mamba/attention, xLSTM, encoder-decoder, and modality-stub archs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    every: int = 1  # MoE MLP every `every`-th layer (others dense)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "silu"  # silu | geglu | gelu
    norm: str = "rmsnorm"
    rope_style: str = "half"  # full | half (2d, chatglm/minicpm) | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    # layer pattern, repeated over depth; entries: attn | mamba | mlstm | slstm
    block_pattern: Tuple[str, ...] = ("attn",)
    # Mamba
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    # encoder-decoder
    enc_layers: int = 0  # >0 => encoder-decoder; n_layers is decoder depth
    # modality stub (audio frames / vision patches prepended as embeddings)
    frontend_tokens: int = 0
    frontend_dim: int = 0
    # numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False
    # scan period (len(block_pattern) must divide n_layers)
    max_seq: int = 532480  # rope table upper bound

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    def __post_init__(self):
        assert self.n_layers % self.period == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern period {self.period}"
        )
        assert self.n_heads % self.n_kv_heads == 0

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    def params_count(self) -> float:
        """Analytic parameter count (for MODEL_FLOPS and memory estimates)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = emb
        per = {}
        # per-block params by kind
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * d
        if self.mla is not None:
            m = self.mla
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                + d * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        dense_mlp = 3 * d * self.d_ff if self.act in ("silu", "geglu") else 2 * d * self.d_ff
        d_inner = self.mamba_expand * d
        mamba = (
            d * 2 * d_inner  # in_proj
            + d_inner * self.mamba_d_conv  # conv
            + d_inner * (2 * self.mamba_d_state + d_inner // 16 + 1)  # ssm projs
            + d_inner * d  # out_proj
        )
        mlstm = d * 2 * d_inner + 4 * d_inner * (d_inner // max(1, self.n_heads)) + d_inner * d
        slstm = 4 * d * d + 4 * d * d + d * self.d_ff if self.d_ff else 8 * d * d
        n_blocks = self.n_layers + self.enc_layers
        for i in range(self.n_layers):
            kind = self.block_pattern[i % self.period]
            if kind == "attn":
                total += attn
            elif kind == "mamba":
                total += mamba
            elif kind == "mlstm":
                total += mlstm
            elif kind == "slstm":
                total += slstm
            # MLP (attn/mamba blocks carry an MLP; xlstm blocks do not)
            if kind in ("attn", "mamba"):
                if self.moe is not None and (i % self.moe.every == self.moe.every - 1):
                    total += self.moe.n_experts * 3 * d * self.moe.d_ff
                else:
                    total += dense_mlp
        total += self.enc_layers * (attn + dense_mlp)
        return float(total)

    def active_params_count(self) -> float:
        """Active parameters per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.params_count()
        d = self.d_model
        full = self.params_count()
        n_moe_layers = sum(
            1
            for i in range(self.n_layers)
            if self.block_pattern[i % self.period] in ("attn", "mamba")
            and i % self.moe.every == self.moe.every - 1
        )
        all_experts = n_moe_layers * self.moe.n_experts * 3 * d * self.moe.d_ff
        active = n_moe_layers * self.moe.top_k * 3 * d * self.moe.d_ff
        return float(full - all_experts + active)
