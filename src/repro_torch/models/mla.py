"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style), through the
port's two attention kernels.

Counterpart of ``repro/models/mla.py`` (``mla_init``, ``mla_apply``,
``mla_cache_init``). Q goes through a low-rank bottleneck (``q_lora_rank``);
K and V are compressed into a shared latent ``c_kv`` (``kv_lora_rank``)
plus one small shared rotary key (``qk_rope_dim``). The decode cache holds
only ``(c_kv, k_rope)``. Per head, queries and keys are
``q_nope ‖ q_rope`` and ``k_nope ‖ k_rope`` (``qk_nope_dim + qk_rope_dim``
wide, the rotary key broadcast over the heads) and values ``v_head_dim``
wide, so attention runs with a value head dim of its own and
``scale = 1 / sqrt(qk_nope_dim + qk_rope_dim)``:

  * prefill (no cache): one causal
    :func:`~repro_torch.kernels.flash_attention.flash_attention` launch per
    layer. The reference cuts prompts over 1 024 tokens into 1 024-query
    chunks to bound its logits' memory; the kernel computes the same
    function in one launch, and the reference's refusal of such a prompt
    that is no multiple of 1 024 is kept;
  * decode (a cache and ``cache_pos``): ``c_kv`` and ``k_rope`` are written
    at ``cache_pos`` in place, the latents of the live positions
    ``0..cache_pos`` only are expanded through ``w_uk`` and ``w_uv``, and
    :func:`~repro_torch.kernels.flash_decode.flash_decode` attends over
    them (``length = cache_pos + 1``). The reference expands the whole
    cache and masks the positions past ``cache_pos`` to -1e30; after the
    softmax those terms are exactly 0, so the results agree.

Rope uses ``qk_rope_dim`` for its tables and rotates in the ``"full"``
style, whatever ``cfg.rope_style`` says (as the reference). Deliberate
differences, as on the GQA path (:mod:`.attention`): the cache is updated
in place, and the kernels keep the softmax ``p`` in f32 into the P.V
product where the reference rounds it to the value dtype first
(``mla.py:99``), so bf16 results differ by that rounding.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_decode import flash_decode
from .layers import dense_init, rmsnorm, rmsnorm_init
from .rope import apply_rope

_CHUNK_Q = 1024  # the reference's query chunk (repro/models/mla.py:103)


def mla_init(gen, d: int, n_heads: int, mla_cfg, dtype, device) -> Dict:
    m = mla_cfg
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    return {
        "w_dq": dense_init(gen, (d, m.q_lora_rank), dtype, device),
        "q_norm": rmsnorm_init(m.q_lora_rank, dtype, device),
        "w_uq": dense_init(gen, (m.q_lora_rank, n_heads * qk_dim), dtype, device),
        "w_dkv": dense_init(gen, (d, m.kv_lora_rank), dtype, device),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dtype, device),
        "w_kr": dense_init(gen, (d, m.qk_rope_dim), dtype, device),
        "w_uk": dense_init(gen, (m.kv_lora_rank, n_heads * m.qk_nope_dim), dtype, device),
        "w_uv": dense_init(gen, (m.kv_lora_rank, n_heads * m.v_head_dim), dtype, device),
        "wo": dense_init(gen, (n_heads * m.v_head_dim, d), dtype, device),
    }


def _keys(params: Dict, c_kv: torch.Tensor, k_rope: torch.Tensor, n_heads: int, m):
    """Per-head keys ``k_nope ‖ k_rope`` and values, (B, S, H, ·), from the
    latents ``c_kv`` (B, S, r_kv) and the shared rotary key (B, S, rope)."""
    B, S, _ = c_kv.shape
    k_nope = (c_kv @ params["w_uk"]).view(B, S, n_heads, m.qk_nope_dim)
    v = (c_kv @ params["w_uv"]).view(B, S, n_heads, m.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, n_heads, m.qk_rope_dim)], dim=-1)
    return k, v


def mla_apply(
    params: Dict,
    x: torch.Tensor,
    *,
    n_heads: int,
    mla_cfg,
    rope_cos,
    rope_sin,
    cache: Optional[Dict] = None,
    cache_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA of ``x`` (B, S, d). ``cache``: {"c_kv" (B, S_cache, r_kv),
    "k_rope" (B, S_cache, rope)}; in decode mode (x is (B, 1, d)) both are
    written at ``cache_pos`` in place and the same dict returns."""
    m = mla_cfg
    B, S, _ = x.shape
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    scale = 1.0 / qk_dim**0.5

    q_lat = rmsnorm(params["q_norm"], x @ params["w_dq"])
    q = (q_lat @ params["w_uq"]).view(B, S, n_heads, qk_dim)
    q_rope = apply_rope(q[..., m.qk_nope_dim:], rope_cos, rope_sin, "full")
    q = torch.cat([q[..., :m.qk_nope_dim], q_rope], dim=-1)

    c_kv = rmsnorm(params["kv_norm"], x @ params["w_dkv"])  # (B, S, r_kv)
    k_rope = (x @ params["w_kr"]).view(B, S, 1, m.qk_rope_dim)
    k_rope = apply_rope(k_rope, rope_cos, rope_sin, "full")[:, :, 0]  # (B, S, rope)

    if cache is not None:
        if S != 1:
            raise ValueError(f"the cache path is single-token decode, got {S} tokens")
        pos = int(cache_pos)
        # in place, where the reference selects into a fresh buffer
        cache["c_kv"][:, pos] = c_kv[:, 0].to(cache["c_kv"].dtype)
        cache["k_rope"][:, pos] = k_rope[:, 0].to(cache["k_rope"].dtype)
        # the live positions only: the reference's -1e30 past pos adds
        # exactly 0 after the softmax
        k, v = _keys(params, cache["c_kv"][:, :pos + 1], cache["k_rope"][:, :pos + 1], n_heads, m)
        out = flash_decode(q[:, 0], k, v, pos + 1, scale=scale).to(x.dtype)
        y = out.reshape(B, 1, n_heads * m.v_head_dim) @ params["wo"]
        return y, cache
    if S > _CHUNK_Q and S % _CHUNK_Q:
        # the reference's own refusal (repro/models/mla.py:113)
        raise ValueError(f"prompt length {S} > {_CHUNK_Q} must be a multiple of {_CHUNK_Q}")
    k, v = _keys(params, c_kv, k_rope, n_heads, m)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
                          scale=scale)
    y = out.transpose(1, 2).reshape(B, S, n_heads * m.v_head_dim) @ params["wo"]
    return y, None


def mla_cache_init(n_layers: int, B: int, S: int, mla_cfg, dtype, device) -> Dict:
    """Zero ``{"c_kv", "k_rope"}``, each with a leading layer axis:
    (n_layers, B, S, kv_lora_rank) and (n_layers, B, S, qk_rope_dim)."""
    return {
        "c_kv": torch.zeros((n_layers, B, S, mla_cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((n_layers, B, S, mla_cfg.qk_rope_dim), dtype=dtype, device=device),
    }
