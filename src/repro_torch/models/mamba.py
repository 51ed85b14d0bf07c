"""Mamba (selective state-space) block: jamba's sub-quadratic component.

Counterpart of ``repro/models/mamba.py`` (``mamba_init`` :19,
``_conv1d_causal`` :38, ``mamba_apply`` :48, ``mamba_state_init`` :105),
with its names and layouts. Everything between ``dt_r @ w_dt`` and
``@ w_out`` -- softplus, ``A = -exp(a_log)``, the selective scan (the
reference's per-token ``step`` through ``chunked_scan``, :82-98), the skip
and the gate -- goes through
:func:`repro_torch.kernels.selective_scan.mamba_scan`: one CUDA kernel
launch a Mamba layer and call on the card, the old composition on the CPU
(:func:`~repro_torch.kernels.selective_scan.mamba_scan_plain`, bit for bit).

Where the port differs in form:

  * parameters are held in the compute dtype, cast once (the reference's
    ``_cast_floats`` casts ``a_log``, ``dt_bias`` and ``d_skip`` with the
    rest on every call): ``A = -exp(a_log)`` is taken in that dtype and
    widened to f32 for the scan, where the reference rounds too;
  * the card's kernel reads ``dt``, ``xc``, ``z``, B and C in the compute
    dtype, each where it lies (``z`` and B, C are strided views of ``xz``
    and ``proj``), and widens them itself: the values the reference's f32
    copies hold, with no copy. It rounds where they round (the softplus,
    the cast before the gate, the gate) and sums the skip unfused; its
    recurrence takes ``exp`` as ``ex2`` of a product folded with log2(e)
    and its sum over n in another order, so on the card ``g`` agrees with
    the composition within rounding (f32) or a bf16 ulp, not bit for bit;
  * the causal conv is the reference's four unrolled taps in the compute
    dtype, not ``F.conv1d`` (cuDNN runs that in TF32 by default and sums in
    another order);
  * a decode step writes its state in place, as the KV cache is written:
    ``state["ssm"]`` (by the kernel, into the state it read) and
    ``state["conv"]`` take the new values and the same dict returns, where
    the reference returns fresh arrays.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import mamba_scan
from .layers import dense_init


def mamba_init(gen, d: int, *, expand: int, d_state: int, d_conv: int, dtype, device) -> Dict:
    """The reference's parameters: the five projections drawn from ``gen``
    (its distribution, not its bits), ``conv_b`` and ``dt_bias`` zeros,
    ``d_skip`` ones, ``a_log = log(1..N)`` for every channel; all in
    ``dtype`` on ``device``."""
    din = expand * d
    dt_rank = max(1, d // 16)
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32)).repeat(din, 1)
    return {
        "w_in": dense_init(gen, (d, 2 * din), dtype, device),
        "conv_w": dense_init(gen, (d_conv, din), dtype, device, scale=1.0 / d_conv),
        "conv_b": torch.zeros((din,), dtype=dtype, device=device),
        "w_x": dense_init(gen, (din, dt_rank + 2 * d_state), dtype, device),
        "w_dt": dense_init(gen, (dt_rank, din), dtype, device),
        "dt_bias": torch.zeros((din,), dtype=dtype, device=device),
        "a_log": a_log.to(device=device, dtype=dtype),
        "d_skip": torch.ones((din,), dtype=dtype, device=device),
        "w_out": dense_init(gen, (din, d), dtype, device),
    }


def _conv1d_causal(x, w, b):
    """Depthwise causal conv. x: (B, S, din), w: (width, din); each tap
    rounded in x's dtype, as the reference's unrolled loop."""
    width, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i : i + S] * w[i]
    return out + b


def mamba_apply(
    params: Dict,
    x: torch.Tensor,
    *,
    expand: int,
    d_state: int,
    d_conv: int,
    state: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d). ``state`` = {"ssm": (B, din, N) f32, "conv": (B,
    width - 1, din)} runs one decode step (S 1) and updates the state in
    place; ``None`` runs the full sequence from a zero state. Returns
    (y, the state or None)."""
    Bsz, S, d = x.shape
    din = expand * d
    dt_rank = max(1, d // 16)
    xz = x @ params["w_in"]
    xs, z = xz[..., :din], xz[..., din:]

    if state is not None:
        if S != 1:
            raise ValueError(f"the state path is single-token decode, got {S} tokens")
        conv_ctx = torch.cat([state["conv"], xs], dim=1)  # (B, width, din)
        xc = (conv_ctx * params["conv_w"][None]).sum(dim=1, keepdim=True) + params["conv_b"]
        state["conv"].copy_(conv_ctx[:, 1:])
    else:
        xc = _conv1d_causal(xs, params["conv_w"], params["conv_b"])
    xc = F.silu(xc)

    proj = xc @ params["w_x"]  # (B, S, dt_rank + 2N)
    dt_r = proj[..., :dt_rank]
    Bm = proj[..., dt_rank : dt_rank + d_state]
    Cm = proj[..., dt_rank + d_state :]
    # softplus(dt), A, the scan, the skip and the gate: one kernel on the card
    g = mamba_scan(dt_r @ params["w_dt"], xc, z, Bm, Cm, params["a_log"], params["dt_bias"],
                   params["d_skip"], state=None if state is None else state["ssm"])
    y = g @ params["w_out"]
    return y, state


def mamba_state_init(B: int, d: int, *, expand: int, d_state: int, d_conv: int, dtype,
                     device) -> Dict:
    """The zero decode state: ``ssm`` (B, din, N) f32 and ``conv`` (B,
    d_conv - 1, din) in ``dtype``."""
    din = expand * d
    return {
        "ssm": torch.zeros((B, din, d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((B, d_conv - 1, din), dtype=dtype, device=device),
    }
