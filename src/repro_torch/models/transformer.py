"""Model assembly for the attention-only transformers: init, cache, forward.

Counterpart of ``repro/models/transformer.py`` for configs whose blocks are
all attention, GQA (chatglm3-6b, granite-8b, gemma-7b) or Multi-head Latent
Attention (minicpm3-4b, :mod:`.mla`), each followed by a dense MLP or, at
the reference's MoE positions, a Mixture-of-Experts MLP (grok-1-314b,
kimi-k2-1t-a32b, :mod:`.moe`). Any other family (Mamba / hybrid, xLSTM,
encoder-decoder, VLM and audio frontends) raises
:class:`NotImplementedError`: ``ROADMAP.md`` lists them as later slices.

Where the reference differs in form only:

  * its ``scan`` over periods is a plain loop over layers here, and the
    parameters are a list of per-layer dicts (``convert.params_from_jax``
    unstacks the reference's leading ``n_periods`` axis);
  * its ``_cast_floats`` casts every float parameter to the compute dtype
    on every call; here parameters are held in the compute dtype, cast
    once when made or converted, which gives the same numbers;
  * gemma's tied embedding is a one-hot contraction there and a gather
    here: exactly one term is non-zero, so the two are equal;
  * ``constrain_batch`` (a no-op on one card) and ``remat`` (which does not
    matter when serving) are left out;
  * the cache keeps the reference's structure, ``{"p0": {"k", "v"}}`` (MLA:
    ``{"p0": {"c_kv", "k_rope"}}``) with a leading layer axis, and a decode
    step updates it in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from .layers import _dtype, dense_init, embed_apply, embed_init, mlp_apply, mlp_init, norm_apply, norm_init
from .rope import rope_table


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is an attention-only transformer (GQA or MLA
    attention), dense or MoE."""
    if (
        cfg.family not in ("dense", "moe") or (cfg.family == "moe") != (cfg.moe is not None)
        or tuple(cfg.block_pattern) != ("attn",) or cfg.enc_layers or cfg.frontend_tokens
    ):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (mla={cfg.mla is not None}, "
            f"moe={cfg.moe is not None}, blocks {cfg.block_pattern}) is not ported yet; "
            "the port serves attention-only configs, GQA or MLA, dense or MoE (ROADMAP.md, "
            "queue 1 item 7)"
        )


def _has_mlp(kind: str) -> bool:
    return kind in ("attn", "mamba")


def _is_moe_position(cfg: ModelConfig, j: int) -> bool:
    """The reference's rule: by the pattern position ``j = i % cfg.period``,
    not by the layer index."""
    return (
        cfg.moe is not None
        and _has_mlp(cfg.block_pattern[j])
        and (j % cfg.moe.every == cfg.moe.every - 1)
    )


# ---------------------------------------------------------------------------
def block_init(cfg: ModelConfig, j: int, gen, dtype, device) -> Dict:
    d = cfg.d_model
    p = {"norm1": norm_init(cfg.norm, d, dtype, device)}
    if cfg.mla is not None:
        p["mla"] = mla_mod.mla_init(gen, d, cfg.n_heads, cfg.mla, dtype, device)
    else:
        p["attn"] = attn.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype, device)
    p["norm2"] = norm_init(cfg.norm, d, dtype, device)
    if _is_moe_position(cfg, j):
        p["moe"] = moe_mod.moe_init(gen, d, cfg.moe, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.act, dtype, device)
    return p


def block_apply(cfg: ModelConfig, params: Dict, x, *, rope_cos, rope_sin, cache=None,
                cache_pos=None, expert_perm=None, moe_chunks: int = 1):
    """One pre-norm block: attention (GQA or MLA) then the MLP or MoE, each
    residual. Returns (x, f32 aux loss: 0 without MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = norm_apply(cfg.norm, params["norm1"], x)
    if cfg.mla is not None:
        y, _ = mla_mod.mla_apply(
            params["mla"], h, n_heads=cfg.n_heads, mla_cfg=cfg.mla, rope_cos=rope_cos,
            rope_sin=rope_sin, cache=cache, cache_pos=cache_pos,
        )
    else:
        y, _ = attn.attn_apply(
            params["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            rope_cos=rope_cos, rope_sin=rope_sin, rope_style=cfg.rope_style, causal=True,
            cache=cache, cache_pos=cache_pos,
        )
    x = x + y
    h = norm_apply(cfg.norm, params["norm2"], x)
    if "moe" in params:
        y, aux = moe_mod.moe_apply(params["moe"], h, moe_cfg=cfg.moe, expert_perm=expert_perm,
                                   n_chunks=moe_chunks)
    else:
        y = mlp_apply(params["mlp"], h, cfg.act)
    return x + y, aux


def cache_init(cfg: ModelConfig, B: int, S: int, device="cuda") -> Dict:
    """Zero KV cache ``{"p0": {"k", "v"}}``, each (n_layers, B, S, Hkv, hd),
    or under MLA ``{"p0": {"c_kv", "k_rope"}}`` (:func:`.mla.mla_cache_init`),
    in the compute dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg.compute_dtype)
    if cfg.mla is not None:
        return {"p0": mla_mod.mla_cache_init(cfg.n_layers, B, S, cfg.mla, dt, dev)}
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    return {"p0": {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
    }}


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Dict:
    """Random parameters with the reference's distribution (not its bits),
    drawn from ``generator`` on its own device and held on ``device`` in the
    compute dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg.compute_dtype)
    params: Dict = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dt, dev),
        "final_norm": norm_init(cfg.norm, cfg.d_model, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab), dt, dev)
    params["blocks"] = [
        block_init(cfg, i % cfg.period, generator, dt, dev) for i in range(cfg.n_layers)
    ]
    return params


# ---------------------------------------------------------------------------
def _rope_tables(cfg: ModelConfig, positions):
    if cfg.mla is not None:  # MLA rotates its rope dims alone, in full style
        rot = cfg.mla.qk_rope_dim
    elif cfg.rope_style == "none":
        return None, None
    else:
        rot = cfg.hd // 2 if cfg.rope_style == "half" else cfg.hd
    return rope_table(positions, rot, cfg.rope_theta)


def forward(
    params: Dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    cache: Optional[Dict] = None,
    cache_pos: Optional[int] = None,
    expert_perm=None,
    moe_chunks: int = 1,
    last_logit_only: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Decoder forward. Returns (f32 logits, cache, f32 aux loss).

    prefill: ``cache=None``, tokens (B, S).
    decode: the cache from :func:`cache_init` and an int ``cache_pos``;
    tokens (B, 1); the cache is updated in place and returned.
    ``expert_perm`` and ``moe_chunks`` go to every MoE layer
    (:func:`.moe.moe_apply`); the aux loss is the sum of the MoE layers'
    (0 for the dense family).
    """
    check_supported(cfg)
    cdt = _dtype(cfg.compute_dtype)
    x = embed_apply(params["embed"], tokens).to(cdt)
    if cfg.name.startswith("gemma"):
        # the reference multiplies by a weakly typed scalar, i.e. by
        # sqrt(d) rounded to the compute dtype
        x = x * torch.tensor(cfg.d_model**0.5, dtype=cdt, device=x.device)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    if cache is not None:
        positions = positions + int(cache_pos)
    cos, sin = _rope_tables(cfg, positions)
    if expert_perm is not None:
        expert_perm = torch.as_tensor(expert_perm, device=x.device).long()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, bp in enumerate(params["blocks"]):
        layer_cache = None
        if cache is not None:
            layer_cache = {name: buf[i] for name, buf in cache["p0"].items()}
        x, aux = block_apply(cfg, bp, x, rope_cos=cos, rope_sin=sin, cache=layer_cache,
                             cache_pos=cache_pos, expert_perm=expert_perm, moe_chunks=moe_chunks)
        aux_total = aux_total + aux
    x = norm_apply(cfg.norm, params["final_norm"], x)
    if last_logit_only:
        x = x[:, -1:]
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T.to(x.dtype)
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    return logits.float(), cache, aux_total
