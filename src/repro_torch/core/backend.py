"""Placement scoring on the device: the fused (ready × resources) matrices.

Counterpart of ``repro.core.backend.JaxScoringBackend.score_matrices``.
One call per activation gathers the ready tasks' read and write CSR rows
and their residency masks on the host, pads them to power-of-two buckets,
copies them to the device and computes there:

  * ``per_read = where(size <= 0, 0, latency + size / bandwidth)``;
  * the transfer fold ``X_u`` (unique memories) through the CUDA kernel
    :func:`repro_torch.kernels.sched_score.transfer_matrix`;
  * the ``col_of`` gather to resources and the additive ``x_bias``;
  * the per-row maxima of ``X``;
  * the affinity fold ``S`` (resident-weighted bytes);
  * the cost ``C = base + X``, ``base`` the class duration per column.

Every entry is bit-equal to ``repro``'s numpy path: the same IEEE
operations in the same order. The division takes a device tensor as its
divisor, because PyTorch on CUDA turns division by a Python scalar into a
multiplication by its reciprocal, which is not bit-exact.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.sched_score import transfer_matrix
from .affinity import affinity_csr_source
from .machine import HOST_MEM


def check_min_wide(min_wide) -> int:
    """Validate a strategy's ``min_wide`` (the narrowest activation that
    is scored on the device)."""
    if isinstance(min_wide, bool) or int(min_wide) != min_wide or min_wide < 1:
        raise ValueError(f"min_wide must be an integer >= 1, got {min_wide!r}")
    return int(min_wide)


def _bucket(n: int, lo: int = 8) -> int:
    """Next power-of-two ≥ n (≥ lo): bounds the distinct shapes."""
    b = lo
    while b < n:
        b *= 2
    return b


def _pad_csr(
    indptr: np.ndarray, values: Sequence[np.ndarray], n_pad: int, r_pad: int
) -> List[np.ndarray]:
    """Scatter gathered CSR rows into dense (n_pad × r_pad) zero-padded blocks."""
    n = len(indptr) - 1
    counts = indptr[1:] - indptr[:-1]
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    cols = np.arange(int(indptr[-1]), dtype=np.int64) - np.repeat(
        indptr[:-1], counts
    )
    out = []
    for v in values:
        dense = np.zeros((n_pad, r_pad), dtype=v.dtype)
        dense[rows, cols] = v
        out.append(dense)
    return out


class TorchScoringBackend:
    """The scoring matrices of HEFT and DADA, computed on ``device``.

    Takes and returns host data (numpy arrays and lists) plus the padded
    device cost matrix ``C_dev``. On ``device="cpu"`` the transfer fold
    runs its plain version.
    """

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self._machine_cache: Dict[tuple, dict] = {}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _machine_arrays(self, resources, transfer_model) -> dict:
        """Activation-invariant per-machine device arrays (cached)."""
        mems = tuple(r.mem for r in resources)
        accel = tuple(r.is_accelerator for r in resources)
        key = (mems, accel, transfer_model.latency, transfer_model.bandwidth)
        m = self._machine_cache.get(key)
        if m is None:
            uniq, col_of, _ = transfer_model.mem_plan(mems)
            dev = self.device
            f64 = torch.float64
            m = dict(
                col_of=torch.tensor(col_of, dtype=torch.int64, device=dev),
                # residency tests shift the full masks by mem+1
                mem_shift=torch.tensor(
                    [u + 1 for u in uniq], dtype=torch.int64, device=dev
                ),
                host_col=torch.tensor(
                    [mem == HOST_MEM for mem in uniq], dtype=torch.bool, device=dev
                ),
                accel_res=torch.tensor(accel, dtype=torch.bool, device=dev),
                latency=torch.tensor(transfer_model.latency, dtype=f64, device=dev),
                bandwidth=torch.tensor(transfer_model.bandwidth, dtype=f64, device=dev),
            )
            self._machine_cache[key] = m
        return m

    def score_matrices(
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
    ) -> dict:
        """Fused (ready × resources) scoring matrices.

        Returns ``{"C": list rows|None, "C_np": array|None, "C_dev":
        device tensor|None, "X_np": array|None, "X_rowmax": list|None,
        "S_np": array|None}``: cost ``C`` (class duration + predicted
        transfer) when per-class durations are given; transfer times
        ``X`` when ``use_cp`` (full rows with ``x_rows=True``, else only
        the per-row maxima); affinity ``S`` when ``affinity`` names a
        resident-weighted score. ``x_bias`` is an additive
        (n × resources) penalty folded into ``X`` before ``C`` and the
        row maxima derive from it.
        """
        mach = self._machine_arrays(resources, sim.transfer_model)
        arr = sim.arrays
        residency = sim.residency
        n = len(tids)
        n_pad = _bucket(n)
        n_res = len(resources)
        tids_arr = np.asarray(tids, dtype=np.int64)
        out = dict(C=None, C_np=None, C_dev=None, X_np=None,
                   X_rowmax=None, S_np=None)

        X = None
        if use_cp:
            r_indptr, r_ids, r_sizes = arr.gather_csr(
                tids_arr, arr.read_indptr, arr.read_ids, arr.read_sizes
            )
            r_pad = _bucket(int((r_indptr[1:] - r_indptr[:-1]).max(initial=1)), lo=1)
            read_masks, read_sizes = _pad_csr(
                r_indptr, [residency.mask_of_ids(r_ids), r_sizes], n_pad, r_pad
            )
            sizes = self._dev(read_sizes)
            per_read = torch.where(
                sizes <= 0.0, 0.0, mach["latency"] + sizes / mach["bandwidth"]
            )
            X_u = transfer_matrix(
                self._dev(read_masks), per_read, mach["mem_shift"], mach["host_col"]
            )
            X = X_u[:, mach["col_of"]]
            if x_bias is not None:
                bias = np.zeros((n_pad, n_res), dtype=np.float64)
                bias[:n] = x_bias
                X = X + self._dev(bias)
            if x_rows:
                out["X_np"] = X[:n].cpu().numpy()
            else:
                out["X_rowmax"] = X[:n].amax(dim=1).tolist()

        if affinity is not None:
            w_indptr_full, w_ids_full, w_weights_full, accel_only = (
                affinity_csr_source(affinity, arr)
            )
            w_indptr, w_ids, w_weights = arr.gather_csr(
                tids_arr, w_indptr_full, w_ids_full, w_weights_full
            )
            w_pad = _bucket(int((w_indptr[1:] - w_indptr[:-1]).max(initial=1)), lo=1)
            write_masks, write_weights = _pad_csr(
                w_indptr,
                [residency.mask_of_ids(w_ids), w_weights.astype(np.float64)],
                n_pad, w_pad,
            )
            wm = self._dev(write_masks)
            ww = self._dev(write_weights)
            shift = mach["mem_shift"]
            S_u = torch.zeros(
                (n_pad, shift.shape[0]), dtype=torch.float64, device=self.device
            )
            for r in range(w_pad):
                resident = ((wm[:, r, None] >> shift[None, :]) & 1) != 0
                S_u = S_u + torch.where(resident, ww[:, r, None], 0.0)
            S = S_u[:, mach["col_of"]]
            if accel_only:
                S = torch.where(mach["accel_res"][None, :], S, 0.0)
            out["S_np"] = S[:n].cpu().numpy()

        if p_cpu is not None:
            pc = np.zeros(n_pad, dtype=np.float64)
            pg = np.zeros(n_pad, dtype=np.float64)
            pc[:n] = p_cpu
            pg[:n] = p_gpu
            base = torch.where(
                mach["accel_res"][None, :],
                self._dev(pg)[:, None], self._dev(pc)[:, None],
            )
            C = base + X if X is not None else base
            out["C_dev"] = C
            out["C_np"] = C[:n].cpu().numpy()
            out["C"] = out["C_np"].tolist()
        return out
