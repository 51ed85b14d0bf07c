"""Model assembly: init, cache and forward of the served configs.

Counterpart of ``repro/models/transformer.py`` for decoder-only configs
whose blocks are attention or Mamba. Attention is GQA (chatglm3-6b,
granite-8b, gemma-7b) or Multi-head Latent Attention (minicpm3-4b,
:mod:`.mla`); the hybrid family (jamba-v0.1-52b) interleaves Mamba blocks
(:mod:`.mamba`) with attention by its block pattern. Every block is
followed by a dense MLP or, at the reference's MoE positions, a
Mixture-of-Experts MLP (grok-1-314b, kimi-k2-1t-a32b, jamba's odd
positions; :mod:`.moe`). xLSTM, encoder-decoder and the VLM and audio
frontends raise :class:`NotImplementedError`: ``ROADMAP.md`` lists them as
later slices.

Where the reference differs in form only:

  * its ``scan`` over periods is a plain loop over layers here, and the
    parameters are a list of per-layer dicts (``convert.params_from_jax``
    unstacks the reference's leading ``n_periods`` axis of each pattern
    position ``p{j}``: layer ``period * k + j`` is period ``k``'s ``p{j}``);
  * its ``_cast_floats`` casts every float parameter to the compute dtype
    on every call; here parameters are held in the compute dtype, cast
    once when made or converted, which gives the same numbers;
  * gemma's tied embedding is a one-hot contraction there and a gather
    here: exactly one term is non-zero, so the two are equal;
  * ``constrain_batch`` (a no-op on one card) and ``remat`` (which does not
    matter when serving) are left out;
  * the cache keeps the reference's structure, one key ``p{j}`` a pattern
    position whose leaves carry a leading ``n_periods`` axis: ``{"k", "v"}``
    (MLA: ``{"c_kv", "k_rope"}``) at attention positions and ``{"ssm",
    "conv"}`` at Mamba positions (an attention-only config has period 1:
    ``{"p0": ...}`` with a leading layer axis); a decode step updates it in
    place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention as attn
from . import mamba as mb
from . import mla as mla_mod
from . import moe as moe_mod
from .layers import _dtype, dense_init, embed_apply, embed_init, mlp_apply, mlp_init, norm_apply, norm_init
from .rope import rope_table


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a decoder-only config the port serves: an
    attention-only transformer (GQA or MLA attention), dense or MoE, or the
    hybrid family (attention and Mamba blocks, GQA attention)."""
    kinds = set(cfg.block_pattern)
    attention_only = (
        cfg.family in ("dense", "moe") and (cfg.family == "moe") == (cfg.moe is not None)
        and tuple(cfg.block_pattern) == ("attn",)
    )
    hybrid = cfg.family == "hybrid" and kinds <= {"attn", "mamba"} and cfg.mla is None
    if not (attention_only or hybrid) or cfg.enc_layers or cfg.frontend_tokens:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (mla={cfg.mla is not None}, "
            f"moe={cfg.moe is not None}, blocks {cfg.block_pattern}) is not ported yet; "
            "the port serves attention-only configs (GQA or MLA, dense or MoE) and the "
            "attention / Mamba hybrid; xLSTM, encoder-decoder and the VLM and audio frontends "
            "are ROADMAP.md, queue 1 items 7(4)-7(6)"
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
def block_init(cfg: ModelConfig, kind: str, j: int, gen, dtype, device) -> Dict:
    """The parameters of one block of ``kind`` ("attn" or "mamba") at
    pattern position ``j``."""
    d = cfg.d_model
    p = {"norm1": norm_init(cfg.norm, d, dtype, device)}
    if kind == "attn":
        if cfg.mla is not None:
            p["mla"] = mla_mod.mla_init(gen, d, cfg.n_heads, cfg.mla, dtype, device)
        else:
            p["attn"] = attn.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype, device)
    elif kind == "mamba":
        p["mamba"] = mb.mamba_init(gen, d, expand=cfg.mamba_expand, d_state=cfg.mamba_d_state,
                                   d_conv=cfg.mamba_d_conv, dtype=dtype, device=device)
    else:
        raise ValueError(kind)
    p["norm2"] = norm_init(cfg.norm, d, dtype, device)
    if _is_moe_position(cfg, j):
        p["moe"] = moe_mod.moe_init(gen, d, cfg.moe, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.act, dtype, device)
    return p


def block_apply(cfg: ModelConfig, kind: str, j: int, params: Dict, x, *, rope_cos, rope_sin,
                cache=None, cache_pos=None, expert_perm=None, moe_chunks: int = 1):
    """One pre-norm block of ``kind`` at pattern position ``j``: attention
    (GQA or MLA) or Mamba, then the MLP or MoE, each residual. ``cache``
    is the layer's slice of the cache, updated in place. Returns (x, f32
    aux loss: 0 without MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = norm_apply(cfg.norm, params["norm1"], x)
    if kind == "attn":
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
    elif kind == "mamba":
        y, _ = mb.mamba_apply(params["mamba"], h, expand=cfg.mamba_expand,
                              d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv, state=cache)
    else:
        raise ValueError(kind)
    x = x + y
    h = norm_apply(cfg.norm, params["norm2"], x)
    if "moe" in params:
        y, aux = moe_mod.moe_apply(params["moe"], h, moe_cfg=cfg.moe, expert_perm=expert_perm,
                                   n_chunks=moe_chunks)
    else:
        y = mlp_apply(params["mlp"], h, cfg.act)
    return x + y, aux


def cache_init(cfg: ModelConfig, B: int, S: int, device="cuda") -> Dict:
    """The zero cache, the reference's ``cache_init``: ``{"p{j}": ...}`` for
    each pattern position ``j``, every leaf with a leading ``n_periods``
    axis. Attention: ``{"k", "v"}``, each (n_periods, B, S, Hkv, hd), or
    under MLA ``{"c_kv", "k_rope"}`` (:func:`.mla.mla_cache_init`), in the
    compute dtype; Mamba: ``{"ssm"}`` (n_periods, B, din, N) f32 and
    ``{"conv"}`` (n_periods, B, d_conv - 1, din) in the compute dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg.compute_dtype)
    n_periods = cfg.n_layers // cfg.period
    out = {}
    for j, kind in enumerate(cfg.block_pattern):
        if kind == "mamba":
            state = mb.mamba_state_init(B, cfg.d_model, expand=cfg.mamba_expand,
                                        d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
                                        dtype=dt, device=dev)
            out[f"p{j}"] = {k: t.new_zeros((n_periods,) + t.shape) for k, t in state.items()}
        elif cfg.mla is not None:
            out[f"p{j}"] = mla_mod.mla_cache_init(n_periods, B, S, cfg.mla, dt, dev)
        else:
            shape = (n_periods, B, S, cfg.n_kv_heads, cfg.hd)
            out[f"p{j}"] = {
                "k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev),
            }
    return out


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
        block_init(cfg, cfg.block_pattern[i % cfg.period], i % cfg.period, generator, dt, dev)
        for i in range(cfg.n_layers)
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
        j = i % cfg.period
        layer_cache = None
        if cache is not None:  # period i // period of position j
            layer_cache = {name: buf[i // cfg.period] for name, buf in cache[f"p{j}"].items()}
        x, aux = block_apply(cfg, cfg.block_pattern[j], j, bp, x, rope_cos=cos, rope_sin=sin,
                             cache=layer_cache, cache_pos=cache_pos, expert_perm=expert_perm,
                             moe_chunks=moe_chunks)
        aux_total = aux_total + aux
    x = norm_apply(cfg.norm, params["final_norm"], x)
    if last_logit_only:
        x = x[:, -1:]
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T.to(x.dtype)
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    return logits.float(), cache, aux_total
