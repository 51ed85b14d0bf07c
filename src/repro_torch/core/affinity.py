"""Resident-weighted affinity scores (paper §3.2).

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

Scores are sums of exact byte counts (integers held in float64, well below
2^53), so every evaluation order gives the same IEEE value. The host
functions here serve activations narrower than a strategy's ``min_wide``;
the device backend folds :func:`affinity_csr_source` itself.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .dag import GraphArrays
from .machine import Resource
from .perfmodel import Residency

RESIDENT_WEIGHTED = ("write_resident", "accel_write", "all_resident", "accel_all")


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
    """(indptr, ids, weights, accel_only) backing the score ``name``."""
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
    raise ValueError(
        f"unknown affinity {name!r} (choose from {RESIDENT_WEIGHTED})"
    )


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
    for j, r in enumerate(resources):
        if accel_only and not r.is_accelerator:
            continue
        bit = 1 << (r.mem + 1)
        resident = (masks & bit) != 0
        out[:, j] = _segment_sum(np.where(resident, weights, 0.0), indptr, n)
    return out


def affinity_rows(
    name: str,
    arr: GraphArrays,
    tids: Sequence[int],
    resources: Sequence[Resource],
    residency: Residency,
) -> List[List[float]]:
    """(tasks × resources) affinity scores as list rows.

    Narrow activations of the two write-resident scores walk the prebuilt
    per-task write lists with bitmask tests; everything else takes the
    batched matrix. Both give the same exact byte-count floats.
    """
    n = len(tids)
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
