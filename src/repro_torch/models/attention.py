"""GQA/MQA self-attention with a KV cache, through the port's two kernels.

Counterpart of ``repro/models/attention.py`` (``attn_init``, ``attn_apply``).
Where the reference computes attention in plain ``jnp`` (``_sdpa`` for a
prompt, a grouped einsum for a decode step), the port routes it through
its kernels, as the reference's docstrings intend:

  * prefill (no cache): :func:`~repro_torch.kernels.flash_attention.flash_attention`
    on ``(B, H, S, hd)`` views of the projections, causal, one launch per
    layer;
  * decode (a cache and ``cache_pos``): the new K/V is written into the
    cache at ``cache_pos`` and
    :func:`~repro_torch.kernels.flash_decode.flash_decode` attends over the
    first ``cache_pos + 1`` positions (the reference's ``kpos <= cache_pos``).

Two differences from the reference, both deliberate. The cache is updated
in place: the reference's masked select writes a fresh buffer, which here
would copy the whole cache every step. And the decode softmax ``p`` stays
f32 into the P.V product, as in ``flash_decode``; the reference's model
rounds it to the cache dtype first (``attention.py:166``), so bf16 results
differ by that rounding. Cross-attention (``attn_apply_kv``, ``kv_source``)
waits for the encoder-decoder family (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_decode import flash_decode
from .layers import dense_init
from .rope import apply_rope

_CHUNK_Q = 1024  # the reference's query chunk (repro/models/attention.py:30)


def attn_init(gen, d: int, n_heads: int, n_kv: int, hd: int, dtype, device) -> Dict:
    return {
        "wq": dense_init(gen, (d, n_heads * hd), dtype, device),
        "wk": dense_init(gen, (d, n_kv * hd), dtype, device),
        "wv": dense_init(gen, (d, n_kv * hd), dtype, device),
        "wo": dense_init(gen, (n_heads * hd, d), dtype, device),
    }


def attn_apply(
    params: Dict,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    hd: int,
    rope_cos=None,
    rope_sin=None,
    rope_style: str = "full",
    causal: bool = True,
    cache: Optional[Dict] = None,
    cache_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention of ``x`` (B, S, d).

    ``cache``: {"k", "v"} of shape (B, S_cache, Hkv, hd). In decode mode
    (x is (B, 1, d)) the new K/V is written at ``cache_pos`` in place and
    attention runs over positions ``<= cache_pos``; the same dict returns.
    """
    B, Sq, _ = x.shape
    q = (x @ params["wq"]).view(B, Sq, n_heads, hd)
    k = (x @ params["wk"]).view(B, Sq, n_kv, hd)
    v = (x @ params["wv"]).view(B, Sq, n_kv, hd)
    if rope_cos is not None:
        q = apply_rope(q, rope_cos, rope_sin, rope_style)
        k = apply_rope(k, rope_cos, rope_sin, rope_style)
    if cache is not None:
        if Sq != 1:
            raise ValueError(f"the cache path is single-token decode, got {Sq} tokens")
        pos = int(cache_pos)
        # in place, where the reference selects into a fresh buffer
        cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
        out = flash_decode(q[:, 0], cache["k"], cache["v"], pos + 1).to(x.dtype)
        y = out.reshape(B, Sq, n_heads * hd) @ params["wo"]
        return y, cache
    if Sq > _CHUNK_Q and Sq % _CHUNK_Q:
        # the reference's own refusal (_sdpa, repro/models/attention.py:69)
        raise ValueError(f"prompt length {Sq} > {_CHUNK_Q} must be a multiple of {_CHUNK_Q}")
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal)
    y = out.transpose(1, 2).reshape(B, Sq, n_heads * hd) @ params["wo"]
    return y, None
