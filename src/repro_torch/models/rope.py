"""Rotary position embeddings: full (llama-style) and half/2d (chatglm,
minicpm-style: only the first half of head_dim is rotated).

Counterpart of ``repro/models/rope.py``: interleaved pairs, tables in f32.
"""
from __future__ import annotations

import torch


def rope_table(positions: torch.Tensor, rot_dim: int, theta: float = 10000.0):
    """cos/sin tables for ``positions`` (any shape) over ``rot_dim`` dims."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=positions.device) / rot_dim
    inv = 1.0 / (theta**exps)
    ang = positions.float()[..., None] * inv  # (..., rot_dim/2)
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """x: (..., rot_dim) -> rotated (interleaved-pair convention)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


def apply_rope(x, cos, sin, style: str = "full"):
    """x: (B, S, H, hd); cos/sin: (S, rot/2) or (B, S, rot/2)."""
    if style == "none":
        return x
    hd = x.shape[-1]
    rot = hd if style == "full" else hd // 2
    if cos.dim() == 2:  # (S, rot/2) -> broadcast over batch and heads
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, rot/2)
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    xr = _rotate(x[..., :rot].float(), c, s).to(x.dtype)
    if rot == hd:
        return xr
    return torch.cat([xr, x[..., rot:]], dim=-1)
