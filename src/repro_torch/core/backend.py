"""Placement scoring on the device: the fused (ready × resources) matrices.

Counterpart of ``repro.core.backend.JaxScoringBackend.score_matrices``.
One call scores one activation. It gathers the ready tasks' read and
affinity-access CSR rows and their residency masks on the host, packs
them as they are (no padding) into one buffer of 8-byte slots
(:func:`repro_torch.kernels.sched_score.pack_activation`), and computes
in one call of :func:`repro_torch.kernels.sched_score.score_activation`:

  * ``per_read = where(size <= 0, 0, latency + size / bandwidth)``;
  * the transfer fold ``X_u`` over the unique memories;
  * the ``col_of`` gather to resources and the additive ``x_bias``;
  * the per-row maxima of ``X``;
  * the affinity fold ``S`` (resident-weighted bytes);
  * the cost ``C = base + X``, ``base`` the class duration per column.

On the card that is one host-to-device copy, one kernel launch, one
device-to-host copy and one synchronisation per activation. On the CPU
the same packed buffer goes through the kernel's plain version. Every
entry is bit-equal to ``repro``'s numpy path: the same IEEE operations in
the same order.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.sched_score import (
    ScoreSpec,
    pack_activation,
    pack_machine,
    score_activation,
    score_layout,
    unpack_outputs,
)
from .affinity import affinity_csr_source
from .machine import HOST_MEM

_MIN_SLOTS = 4096  # 32 KiB: the main path's widest activation fits


def check_min_wide(min_wide) -> int:
    """Validate a strategy's ``min_wide`` (the narrowest activation that
    is scored on the device)."""
    if isinstance(min_wide, bool) or int(min_wide) != min_wide or min_wide < 1:
        raise ValueError(f"min_wide must be an integer >= 1, got {min_wide!r}")
    return int(min_wide)


def _grown(buf: Optional[torch.Tensor], k: int, **kwargs) -> torch.Tensor:
    """``buf`` if it holds ``k`` slots, else a new buffer of at least twice
    its size (and at least ``_MIN_SLOTS``)."""
    if buf is not None and buf.shape[0] >= k:
        return buf
    size = max(k, _MIN_SLOTS, 0 if buf is None else 2 * buf.shape[0])
    return torch.empty(size, **kwargs)


class TorchScoringBackend:
    """The scoring matrices of HEFT and DADA, computed on ``device``.

    Takes and returns host data (numpy arrays and lists). On the card the
    backend owns its staging buffers: a pinned host buffer and a device
    buffer each way, grown by doubling and never allocated per call.
    """

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self._machine_cache: Dict[tuple, tuple] = {}
        self._host_in = self._host_out = self._dev_in = self._dev_out = None

    def _machine(self, resources, transfer_model):
        """(n_u, the machine buffer on the device): the activation-invariant
        per-machine constants, cached per machine."""
        mems = tuple(r.mem for r in resources)
        accel = tuple(r.is_accelerator for r in resources)
        key = (mems, accel, transfer_model.latency, transfer_model.bandwidth)
        m = self._machine_cache.get(key)
        if m is None:
            uniq, col_of, _ = transfer_model.mem_plan(mems)
            buf = pack_machine(
                len(resources),
                latency=transfer_model.latency, bandwidth=transfer_model.bandwidth,
                # residency tests shift the full masks by mem+1
                mem_shift=[u + 1 for u in uniq],
                host_col=[mem == HOST_MEM for mem in uniq],
                col_of=col_of, accel_res=accel,
            )
            m = (len(uniq), torch.from_numpy(buf).to(self.device))
            self._machine_cache[key] = m
        return m

    def _staging(self, n_in: int, n_out: int) -> None:
        """Grow the owned buffers to hold ``n_in`` input and ``n_out``
        output slots (on the CPU only the input buffer, not pinned)."""
        on_card = self.device.type == "cuda"
        self._host_in = _grown(self._host_in, n_in, dtype=torch.int64, pin_memory=on_card)
        if on_card:
            self._dev_in = _grown(self._dev_in, n_in, dtype=torch.int64, device=self.device)
            self._host_out = _grown(self._host_out, n_out, dtype=torch.float64, pin_memory=True)
            self._dev_out = _grown(self._dev_out, n_out, dtype=torch.float64, device=self.device)

    def pack(
        self,
        sim,
        tids: Sequence[int],
        resources,
        *,
        p_cpu: Optional[Sequence[float]] = None,
        p_gpu: Optional[Sequence[float]] = None,
        use_cp: bool = False,
        affinity: Optional[str] = None,
        x_rows: bool = False,
        x_bias: Optional[np.ndarray] = None,
    ):
        """Gather one activation's CSR rows on the host and pack them into
        the host staging buffer. Returns ``(layout, packed, machine)``: the
        activation's :class:`ScoreLayout`, a view of the staging buffer
        holding it (valid until the next call) and the machine buffer on
        the device. The arguments are :meth:`score_matrices`'s."""
        n_u, machine = self._machine(resources, sim.transfer_model)
        arr = sim.arrays
        residency = sim.residency
        tids_arr = np.asarray(tids, dtype=np.int64)
        reads = writes = None
        if use_cp:
            r_indptr, r_ids, r_sizes = arr.gather_csr(
                tids_arr, arr.read_indptr, arr.read_ids, arr.read_sizes
            )
            reads = (r_indptr, residency.mask_of_ids(r_ids), r_sizes)
        accel_only = False
        if affinity is not None:
            w_indptr_full, w_ids_full, w_weights_full, accel_only = (
                affinity_csr_source(affinity, arr)
            )
            w_indptr, w_ids, w_weights = arr.gather_csr(
                tids_arr, w_indptr_full, w_ids_full, w_weights_full
            )
            writes = (w_indptr, residency.mask_of_ids(w_ids), w_weights)
        want_c = p_cpu is not None
        want_bias = use_cp and x_bias is not None
        layout = score_layout(ScoreSpec(
            n=len(tids), nnz_r=len(reads[1]) if use_cp else 0,
            nnz_w=len(writes[1]) if writes is not None else 0,
            n_u=n_u, n_res=len(resources),
            want_x=use_cp, x_rows=use_cp and x_rows, want_bias=want_bias,
            want_s=writes is not None, accel_only=accel_only, want_c=want_c,
        ))
        self._staging(layout.n_in, layout.n_out)
        packed = self._host_in[:layout.n_in]
        pack_activation(
            packed.numpy(), layout, reads=reads, writes=writes,
            p_cpu=p_cpu if want_c else None, p_gpu=p_gpu if want_c else None,
            x_bias=x_bias if want_bias else None,
        )
        return layout, packed, machine

    def score_matrices(self, sim, tids: Sequence[int], resources, **kwargs) -> dict:
        """Fused (ready × resources) scoring matrices.

        Keywords: ``p_cpu`` and ``p_gpu`` (per-class durations), ``use_cp``,
        ``affinity``, ``x_rows`` and ``x_bias``. Returns ``{"C": list
        rows|None, "C_np": array|None, "X_np": array|None, "X_rowmax":
        list|None, "S_np": array|None}``: cost ``C`` (class duration +
        predicted transfer) when per-class durations are given; transfer
        times ``X`` when ``use_cp`` (full rows with ``x_rows=True``, else
        only the per-row maxima); affinity ``S`` when ``affinity`` names a
        resident-weighted score. ``x_bias`` is an additive (n × resources)
        penalty folded into ``X`` before ``C`` and the row maxima derive
        from it.
        """
        layout, packed, machine = self.pack(sim, tids, resources, **kwargs)
        if self.device.type == "cuda":
            dev_in = self._dev_in[:layout.n_in]
            dev_out = self._dev_out[:layout.n_out]
            host_out = self._host_out[:layout.n_out]
            dev_in.copy_(packed, non_blocking=True)
            score_activation(dev_in, layout, machine, out=dev_out)
            host_out.copy_(dev_out, non_blocking=True)
            # the one synchronisation of the call: the results are on the
            # host, and both staging buffers are free for the next call
            torch.cuda.current_stream(self.device).synchronize()
            result = host_out.numpy().copy()
        else:
            result = score_activation(packed, layout, machine).numpy()
        got = unpack_outputs(result, layout)
        return dict(
            C=got["C"].tolist() if got["C"] is not None else None, C_np=got["C"],
            X_np=got["X"],
            X_rowmax=got["X_max"].tolist() if got["X_max"] is not None else None,
            S_np=got["S"],
        )
