"""Shared layers: norms, MLPs, embeddings (param-dict style, as ``repro``'s).

Counterpart of ``repro/models/layers.py``. Parameters are plain dicts of
tensors; ``dense_init`` draws the reference's distribution (a standard
normal times ``1/sqrt(fan_in)``) from an explicit :class:`torch.Generator`,
not its bits.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def dense_init(gen: torch.Generator, shape, dtype, device, scale: Optional[float] = None):
    """A normal draw times ``scale`` (default ``1/sqrt(shape[0])``), drawn in
    f32 on the generator's device and stored in ``dtype`` on ``device``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / (fan_in**0.5)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return w.mul_(scale).to(device=device, dtype=dtype)


def rmsnorm_init(d: int, dtype, device) -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    # the variance in f32, the products in x's dtype (as the reference)
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def layernorm_init(d: int, dtype, device) -> Dict:
    return {
        "scale": torch.ones((d,), dtype=dtype, device=device),
        "bias": torch.zeros((d,), dtype=dtype, device=device),
    }


def layernorm(params, x, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    mu = mu.to(x.dtype)
    return (x - mu) * inv * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def norm_init(kind: str, d: int, dtype, device):
    return rmsnorm_init(d, dtype, device) if kind == "rmsnorm" else layernorm_init(d, dtype, device)


def norm_apply(kind: str, params, x):
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# ---------------------------------------------------------------------------
def mlp_init(gen, d: int, d_ff: int, act: str, dtype, device) -> Dict:
    p = {
        "w_up": dense_init(gen, (d, d_ff), dtype, device),
        "w_down": dense_init(gen, (d_ff, d), dtype, device),
    }
    if act in ("silu", "geglu"):  # gated variants carry a gate projection
        p["w_gate"] = dense_init(gen, (d, d_ff), dtype, device)
    return p


def mlp_apply(params, x, act: str):
    up = x @ params["w_up"]
    if act == "silu":
        h = F.silu(x @ params["w_gate"]) * up
    elif act == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
def embed_init(gen, vocab: int, d: int, dtype, device) -> Dict:
    return {"table": dense_init(gen, (vocab, d), dtype, device, scale=1.0)}


def embed_apply(params, tokens):
    return params["table"][tokens]
