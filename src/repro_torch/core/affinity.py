"""Affinity scores (paper §3.2, and one beyond it).

The paper's definition: "they were computed using the amount of data updated
by each task. For instance, a task that writes or modifies a data stored on a
resource R has a high score and is prone to be scheduled on R."

A resident-weighted score sums, per (task, resource), a per-access weight
over the accesses whose data has a valid copy in the resource's memory:

  write_resident  bytes written (W/RW)
  accel_write     the same, on accelerators only (host-resident data gives
                  no locality signal: every CPU reaches host memory for
                  free) — DADA's default
  all_resident    bytes of every distinct accessed datum, writes double
  accel_all       the same, on accelerators only

and one score beyond the paper's family:

  missing_bytes   minus the bytes the task's reads would move to the
                  resource's memory, each times its path length
                  (:meth:`~repro_torch.core.perfmodel.Residency.transfer_hops`:
                  0 where resident or where the datum exists nowhere yet,
                  1 through the host, 2 device to device). A zero sum is
                  negated into -0.0, as the reference negates it; compare
                  scores with ``==``. No entry is ever above 0, so DADA's
                  affinity phase, which wants a score above 0, finds no
                  preference under it.

Scores are sums of exact byte counts (integers held in float64, well below
2^53; under missing_bytes times 0, 1 or 2), so every evaluation order gives
the same IEEE value. The host functions here serve activations narrower
than a strategy's ``min_wide``; the device backend folds
:func:`affinity_csr_source` itself (the reads and their sizes under
missing_bytes, with the scorer's ``s_missing`` flag).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .dag import GraphArrays
from .machine import HOST_MEM, Resource
from .perfmodel import Residency

RESIDENT_WEIGHTED = ("write_resident", "accel_write", "all_resident", "accel_all")
MISSING_BYTES = "missing_bytes"
AFFINITIES = RESIDENT_WEIGHTED + (MISSING_BYTES,)


def _all_resident_weights(arr: GraphArrays) -> np.ndarray:
    """Per-access weight for the all_resident score: first occurrence of a
    name within a task counts (2x for writes), duplicates count 0."""
    w = arr.cache.get("all_resident_weights")
    if w is None:
        w = np.where(
            arr.acc_first, np.where(arr.acc_writes, 2.0, 1.0), 0.0
        ) * arr.acc_sizes
        arr.cache["all_resident_weights"] = w
    return w


def affinity_csr_source(name: str, arr: GraphArrays):
    """(indptr, ids, weights, accel_only) backing the score ``name``: under
    missing_bytes the reads, weighted by their sizes."""
    if name in ("write_resident", "accel_write"):
        return (
            arr.write_indptr, arr.write_ids, arr.write_sizes,
            name == "accel_write",
        )
    if name in ("all_resident", "accel_all"):
        return (
            arr.acc_indptr, arr.acc_ids, _all_resident_weights(arr),
            name == "accel_all",
        )
    if name == MISSING_BYTES:
        return arr.read_indptr, arr.read_ids, arr.read_sizes, False
    raise ValueError(f"unknown affinity {name!r} (choose from {AFFINITIES})")


def _segment_sum(values: np.ndarray, indptr: np.ndarray, n: int) -> np.ndarray:
    """Sum ``values`` per CSR segment (empty segments yield 0)."""
    col = np.add.reduceat(np.append(values, 0.0), indptr[:-1])[:n]
    empty = indptr[:-1] == indptr[1:]
    if empty.any():
        col = np.where(empty, 0.0, col)
    return col


def affinity_matrix(
    name: str,
    arr: GraphArrays,
    tids: np.ndarray,
    resources: Sequence[Resource],
    residency: Residency,
) -> np.ndarray:
    """(tasks × resources) scores over the CSR incidence."""
    indptr_full, ids_full, weights_full, accel_only = affinity_csr_source(name, arr)
    indptr, ids, weights = arr.gather_csr(tids, indptr_full, ids_full, weights_full)
    n = len(tids)
    out = np.zeros((n, len(resources)), dtype=np.float64)
    if len(ids) == 0:
        return out
    masks = residency.mask_of_ids(ids)
    if name == MISSING_BYTES:
        return _missing_bytes_matrix(out, masks, weights, indptr, resources)
    for j, r in enumerate(resources):
        if accel_only and not r.is_accelerator:
            continue
        bit = 1 << (r.mem + 1)
        resident = (masks & bit) != 0
        out[:, j] = _segment_sum(np.where(resident, weights, 0.0), indptr, n)
    return out


def _missing_bytes_matrix(out, masks, sizes, indptr, resources) -> np.ndarray:
    """missing_bytes over gathered reads (the reference's matrix form)."""
    n = out.shape[0]
    on_host = (masks & 1) != 0
    nowhere = masks == 0
    for j, r in enumerate(resources):
        resident = (masks & (1 << (r.mem + 1))) != 0
        if r.mem == HOST_MEM:
            hops = np.where(resident | nowhere, 0.0, 1.0)
        else:
            hops = np.where(resident | nowhere, 0.0, np.where(on_host, 1.0, 2.0))
        out[:, j] = -_segment_sum(np.where(resident, 0.0, sizes * hops), indptr, n)
    return out


def score_missing_bytes(arr: GraphArrays, tid: int, resource: Resource,
                        residency: Residency) -> float:
    """missing_bytes of one (task, resource) pair (the reference's scalar
    form): minus the task's read bytes times their hops to the resource."""
    missing = 0
    for _, name, size in arr.task_reads[tid]:
        missing += size * residency.transfer_hops(name, resource.mem)
    return -float(missing)


def affinity_rows(
    name: str,
    arr: GraphArrays,
    tids: Sequence[int],
    resources: Sequence[Resource],
    residency: Residency,
) -> List[List[float]]:
    """(tasks × resources) affinity scores as list rows.

    Narrow activations of the two write-resident scores walk the prebuilt
    per-task write lists with bitmask tests, and of missing_bytes take its
    scalar form; everything else takes the batched matrix. All give the
    same exact byte-count floats (up to the sign of a zero).
    """
    n = len(tids)
    if n < 32 and name == MISSING_BYTES:
        return [[score_missing_bytes(arr, t, r, residency) for r in resources] for t in tids]
    if n >= 32 or name not in ("accel_write", "write_resident"):
        return affinity_matrix(
            name, arr, np.asarray(tids, dtype=np.int64), resources, residency
        ).tolist()
    accel_only = name == "accel_write"
    masks = residency._mask
    # 0 is not a valid memory bit, so it doubles as the skip sentinel
    # for non-accelerator columns
    res_bits = [
        0 if (accel_only and not r.is_accelerator) else 1 << (r.mem + 1)
        for r in resources
    ]
    active = [(j, bit) for j, bit in enumerate(res_bits) if bit]
    union = 0
    for _, bit in active:
        union |= bit
    zero_row = [0.0] * len(resources)
    out = []
    for tid in tids:
        writes = [(masks.get(nm, 0), sz) for _, nm, sz in arr.task_writes[tid]]
        any_mask = 0
        for m, _ in writes:
            any_mask |= m
        if not any_mask & union:
            # nothing this task writes is resident on a scored memory:
            # the row is all zeros (shared; rows are read-only)
            out.append(zero_row)
            continue
        row = zero_row.copy()
        for j, bit in active:
            total = 0
            for m, sz in writes:
                if m & bit:
                    total += sz
            if total:
                row[j] = float(total)
        out.append(row)
    return out
