"""Tile LU (PLASMA DGETRF task shape) as a data-flow task graph.

Task kinds / flop counts (tile size b):
  getrf  2/3 b^3    gessm  b^3     tstrf  b^3     ssssm  2 b^3
Total ~ 2 n^3 / 3.

Tile bodies (counterparts of ``repro.linalg.lu``'s): the same no-pivot
right-looking block LU as the reference, which has PLASMA's task and
dependency shape and is safe on the diagonally dominant test matrices.
getrf is a rank-1 loop of plain torch ops, gessm and tstrf call
``torch.linalg.solve_triangular``, and ssssm runs in the ``gemm_update``
kernel.
"""
from __future__ import annotations

import torch

from ..core.dag import Mode, TaskGraph
from ..kernels.tile_gemm import gemm_update
from .tiles import make_tile_objects


def _getrf(a_kk):
    """No-pivot in-tile LU: returns packed L\\U (unit lower not stored).

    The reference's ``fori_loop`` masks whole columns and rows; the rows
    and columns its masks leave out get ``a - 0`` there, so slicing them
    away gives the same numbers with three ops per step.
    """
    a = a_kk.clone(memory_format=torch.contiguous_format)
    for k in range(a.shape[0] - 1):
        a[k + 1:, k].div_(a[k, k])
        a[k + 1:, k + 1:].sub_(torch.outer(a[k + 1:, k], a[k, k + 1:]))
    return (a,)


def _split_lu(packed):
    l = torch.tril(packed, -1) + torch.eye(packed.shape[0], dtype=packed.dtype, device=packed.device)
    u = torch.triu(packed)
    return l, u


def _gessm(a_kk, a_kj):
    l, _ = _split_lu(a_kk)
    x = torch.linalg.solve_triangular(l, a_kj, upper=False, unitriangular=True)
    return (x.contiguous(),)


def _tstrf(a_kk, a_ik):
    _, u = _split_lu(a_kk)
    # A[i,k] <- A[i,k] U^{-1}
    x = torch.linalg.solve_triangular(u.T, a_ik.T, upper=False)
    return (x.T.contiguous(),)


def _ssssm(a_ik, a_kj, a_ij):
    return (gemm_update(a_ij, a_ik, a_kj, alpha=-1.0),)


def lu_graph(
    n_tiles: int, tile: int = 512, itemsize: int = 8, with_fns: bool = True
) -> TaskGraph:
    g = TaskGraph()
    A = make_tile_objects("A", n_tiles, tile, itemsize)
    b3 = float(tile) ** 3
    fns = with_fns
    for k in range(n_tiles):
        g.add_task("getrf", [(A[(k, k)], Mode.RW)], flops=2.0 * b3 / 3.0,
                   fn=_getrf if fns else None, tag=("getrf", k))
        for j in range(k + 1, n_tiles):
            g.add_task(
                "gessm",
                [(A[(k, k)], Mode.R), (A[(k, j)], Mode.RW)],
                flops=b3,
                fn=_gessm if fns else None,
                tag=("gessm", k, j),
            )
        for i in range(k + 1, n_tiles):
            g.add_task(
                "tstrf",
                [(A[(k, k)], Mode.R), (A[(i, k)], Mode.RW)],
                flops=b3,
                fn=_tstrf if fns else None,
                tag=("tstrf", i, k),
            )
            for j in range(k + 1, n_tiles):
                g.add_task(
                    "ssssm",
                    [
                        (A[(i, k)], Mode.R),
                        (A[(k, j)], Mode.R),
                        (A[(i, j)], Mode.RW),
                    ],
                    flops=2.0 * b3,
                    fn=_ssssm if fns else None,
                    tag=("ssssm", i, j, k),
                )
    return g
