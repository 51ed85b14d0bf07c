"""Mixture-of-Experts MLP: sort-based capacity dispatch.

Counterpart of ``repro/models/moe.py``, the same function step by step:
top-k routing over an f32 router, assignments sorted by expert (a stable
sort per token chunk), bucketed into a fixed per-expert capacity buffer
(E, C, d), overflow sent to a scratch slot ``C`` and dropped, the gated
expert FFN as batched matrix products, and the combine through a padded
zero slot, weighted by the renormalised gates.

``expert_perm`` (from :func:`repro_torch.dist.sched_bridge.plan_expert_placement`)
relabels expert ids before the aux loss and the dispatch, so co-activated
experts land in one device group: with the expert weights permuted to
their new slots the output is unchanged.

Where the reference's primitives leave room, the port pins them down:

  * ``jax.lax.top_k`` puts the lower index first among equal values;
    ``torch.topk`` promises no order for ties, so top-k here is a stable
    descending sort cut to its first K;
  * the router product runs in true f32 (TF32 switched off around it on
    the card): bf16-level noise in the logits would flip routes;
  * many overflowing assignments write the scratch slot ``C``, in an
    order ``index_put_`` leaves undefined; the slot is cut off before the
    expert products, as in the reference, so the order never shows.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init


def moe_init(gen: torch.Generator, d: int, moe_cfg, dtype, device) -> Dict:
    """The reference's distribution (not its bits): ``dense_init`` takes
    ``fan_in = shape[0]``, which is ``E`` for the (E, d, ff) expert tensors.
    Each expert is drawn on its own in f32 and stored in ``dtype``, so no
    f32 temporary of a whole expert tensor is made."""
    E, ff = moe_cfg.n_experts, moe_cfg.d_ff
    out = {"router": dense_init(gen, (d, E), dtype, device)}
    scale = 1.0 / (E**0.5)
    for name, shape in (("w_up", (d, ff)), ("w_gate", (d, ff)), ("w_down", (ff, d))):
        w = torch.empty((E,) + shape, dtype=dtype, device=device)
        for e in range(E):
            draw = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
            w[e].copy_(draw.mul_(scale))
        out[name] = w
    return out


@contextlib.contextmanager
def _true_f32(device: torch.device):
    """Switch TF32 off for CUDA matrix products inside the block."""
    if device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _experts(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("xecd,edf->xecf", buf, w)`` as one batched product over E."""
    X, E, C, d = buf.shape
    a = buf.reshape(E, C, d) if X == 1 else buf.transpose(0, 1).reshape(E, X * C, d)
    out = torch.bmm(a, w)
    return out.reshape(X, E, C, -1) if X == 1 else out.reshape(E, X, C, -1).transpose(0, 1)


def route(params: Dict, xt: torch.Tensor, moe_cfg, expert_perm=None):
    """Top-k routing of the (T, d) tokens ``xt``: the f32 softmax ``probs``
    (T, E), the renormalised ``gates`` (T, K) and the (relabelled) expert
    ids ``idx`` (T, K), the highest probability first."""
    K = moe_cfg.top_k
    with _true_f32(xt.device):
        logits = xt.float() @ params["router"].float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :K], idx[:, :K]  # lax.top_k's order
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    if expert_perm is not None:
        idx = torch.as_tensor(expert_perm, device=xt.device).long()[idx]
    return probs, gates, idx


def dispatch_shape(T: int, n_chunks: int, moe_cfg) -> Tuple[int, int, int]:
    """(chunks X, tokens a chunk Tc, capacity C) of a dispatch of T tokens:
    ``n_chunks`` falls back to 1 when it does not divide T."""
    X = n_chunks if (n_chunks > 1 and T % n_chunks == 0) else 1
    Tc = T // X
    C = max(8, int((Tc * moe_cfg.top_k / moe_cfg.n_experts) * moe_cfg.capacity_factor + 0.999))
    return X, Tc, C


def moe_apply(
    params: Dict,
    x: torch.Tensor,
    *,
    moe_cfg,
    expert_perm: Optional[torch.Tensor] = None,
    n_chunks: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, f32 aux loss).

    ``n_chunks`` > 1 sorts and buckets each of ``n_chunks`` token chunks on
    its own (the reference's chunk-local dispatch); it falls back to one
    chunk when it does not divide the B·S tokens.
    """
    B, S, d = x.shape
    E, K = moe_cfg.n_experts, moe_cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    dev = x.device
    probs, gates, idx = route(params, xt, moe_cfg, expert_perm)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, idx.reshape(-1), torch.ones(T * K, dtype=torch.float32, device=dev)
    ) / (T * K)
    aux = moe_cfg.aux_loss_weight * E * torch.sum(me * ce)

    X, Tc, C = dispatch_shape(T, n_chunks, moe_cfg)
    xtc = xt.reshape(X, Tc, d)
    flat_e = idx.reshape(X, Tc * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # per-chunk sort
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((X, E), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e)
    )
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(Tc * K, device=dev)[None] - torch.gather(starts, 1, sorted_e)
    tok = order // K
    slot = torch.where(rank < C, rank, torch.full_like(rank, C))  # overflow -> slot C

    chunk_ix = torch.arange(X, device=dev)[:, None]
    buf = torch.zeros((X, E, C + 1, d), dtype=x.dtype, device=dev)
    buf[chunk_ix, sorted_e, slot] = xtc[chunk_ix, tok]
    buf = buf[:, :, :C]  # the scratch slot goes before any product reads it

    # ---- expert FFN (gated) ----------------------------------------------
    up = _experts(buf, params["w_up"])
    gate = F.silu(_experts(buf, params["w_gate"]))
    y_exp = _experts(gate * up, params["w_down"])

    # ---- combine back ------------------------------------------------------
    y_pad = torch.cat([y_exp, torch.zeros((X, E, 1, d), dtype=y_exp.dtype, device=dev)], dim=2)
    y_sorted = y_pad[chunk_ix, sorted_e, slot]  # (X, Tc*K, d)
    y_flat = torch.empty_like(y_sorted)
    y_flat[chunk_ix, order] = y_sorted  # order is a permutation: every row once
    yk = y_flat.reshape(T, K, d)
    y = (yk * gates[..., None].to(yk.dtype)).sum(dim=1)
    return y.reshape(B, S, d), aux
