"""Tile QR (PLASMA DGEQRF, flat reduction tree) as a data-flow task graph.

Task kinds / flop counts (tile size b):
  geqrt  4/3 b^3   ormqr  2 b^3   tsqrt  10/3 b^3   tsmqr  4 b^3
Leading-order total ~ 4 n^3 / 3 (tsmqr dominates). The T tiles have
PLASMA's sizes (ib x b), so simulated transfer volumes stay faithful.

Tile bodies (counterparts of ``repro.linalg.qr``'s): like the reference,
they store explicit Q factors in the T-tile slots (T[k,k]: b x b, T[i,k]:
2b x 2b) instead of LAPACK's compact-WY pair. geqrt and tsqrt call
``torch.linalg.qr``; ormqr and tsmqr apply Q^T in the ``gemm_update``
kernel (through ``matmul``). That kernel has no transposed A, as the
reference's has none, so the bodies transpose Q by a row-major copy;
Q is stored as ``torch.linalg.qr`` returns it (column-major), so that
copy is usually a no-op.
"""
from __future__ import annotations

import torch

from ..core.dag import DataObject, Mode, TaskGraph
from ..kernels.tile_gemm import matmul
from .tiles import make_tile_objects, tile_name


def _geqrt(a_kk):
    q, r = torch.linalg.qr(a_kk, mode="complete")
    return (r.contiguous(), q)  # writes: A[k,k] <- R, T[k,k] <- Q


def _ormqr(q_kk, a_kj):
    return (matmul(q_kk.T.contiguous(), a_kj),)


def _tsqrt(a_kk, a_ik):
    b = a_kk.shape[0]
    s = torch.cat([a_kk, a_ik], dim=0)  # (2b, b)
    q, r = torch.linalg.qr(s, mode="complete")  # q: (2b,2b) r: (2b,b)
    # A[k,k] <- R, A[i,k] <- 0, T[i,k] <- Q
    return (r[:b].contiguous(), torch.zeros_like(a_ik), q)


def _tsmqr(q_ik, a_kj, a_ij):
    b = a_kj.shape[0]
    s = matmul(q_ik.T.contiguous(), torch.cat([a_kj, a_ij], dim=0))
    return (s[:b], s[b:])


def qr_graph(
    n_tiles: int,
    tile: int = 512,
    inner_block: int = 128,
    itemsize: int = 8,
    with_fns: bool = True,
) -> TaskGraph:
    g = TaskGraph()
    A = make_tile_objects("A", n_tiles, tile, itemsize)
    # T tiles: PLASMA stores ib x b blocks of the block reflectors
    T = {
        (i, k): DataObject(
            name=tile_name("T", i, k),
            size_bytes=inner_block * tile * itemsize,
            meta=("T", i, k),
        )
        for i in range(n_tiles)
        for k in range(n_tiles)
    }
    b3 = float(tile) ** 3
    fns = with_fns
    for k in range(n_tiles):
        g.add_task(
            "geqrt",
            [(A[(k, k)], Mode.RW), (T[(k, k)], Mode.W)],
            flops=4.0 * b3 / 3.0,
            fn=_geqrt if fns else None,
            tag=("geqrt", k),
        )
        for j in range(k + 1, n_tiles):
            g.add_task(
                "ormqr",
                [(T[(k, k)], Mode.R), (A[(k, j)], Mode.RW)],
                flops=2.0 * b3,
                fn=_ormqr if fns else None,
                tag=("ormqr", k, j),
            )
        for i in range(k + 1, n_tiles):
            g.add_task(
                "tsqrt",
                [(A[(k, k)], Mode.RW), (A[(i, k)], Mode.RW), (T[(i, k)], Mode.W)],
                flops=10.0 * b3 / 3.0,
                fn=_tsqrt if fns else None,
                tag=("tsqrt", i, k),
            )
            for j in range(k + 1, n_tiles):
                g.add_task(
                    "tsmqr",
                    [
                        (T[(i, k)], Mode.R),
                        (A[(k, j)], Mode.RW),
                        (A[(i, j)], Mode.RW),
                    ],
                    flops=4.0 * b3,
                    fn=_tsmqr if fns else None,
                    tag=("tsmqr", i, j, k),
                )
    return g
