"""The recurrent scan of the state-space and recurrent cells, as a plain loop.

Counterpart of ``repro/models/recurrent.py::chunked_scan`` (:14), which
equals ``jax.lax.scan(step, carry, seq)`` and scans over chunks of 256
steps with a checkpointed inner scan. The chunking only bounds what
automatic differentiation saves (one carry a chunk instead of one a step);
the forward values are the same. The port has no backward, so this is the
scan alone: a Python loop over the leading axis. On the card the Mamba
block does not run it per step: its selective scan is one kernel
(:mod:`repro_torch.kernels.selective_scan`), and this loop is that
kernel's plain version.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def chunked_scan(step: Callable, carry,
                 seq: Sequence[torch.Tensor]) -> Tuple[object, torch.Tensor]:
    """``lax.scan(step, carry, seq)``: ``seq`` a tuple of tensors with a
    common leading axis S; ``step(carry, xs_t) -> (carry, y_t)``. Returns
    the last carry and the ``y_t`` stacked along a new leading axis."""
    seq = tuple(seq)
    if seq[0].shape[0] == 0:
        raise ValueError("chunked_scan needs at least one step")
    ys = []
    for t in range(seq[0].shape[0]):
        carry, y = step(carry, tuple(a[t] for a in seq))
        ys.append(y)
    return carry, torch.stack(ys)
