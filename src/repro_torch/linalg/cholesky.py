"""Tile Cholesky (PLASMA DPOTRF, right-looking) as a data-flow task graph.

Task kinds / flop counts (tile size b):
  potrf  b^3/3      trsm  b^3      syrk  b^3      gemm  2 b^3
Total ~ n^3/3 for an n x n matrix — the standard Cholesky count the paper's
GFLOPS plots use.

Tile bodies (counterparts of ``repro.linalg.cholesky``'s): potrf and trsm
call ``torch.linalg``; syrk and gemm run in the ``gemm_update`` kernel.
``torch.linalg`` returns column-major results, so those bodies hand back a
row-major copy, the layout ``gemm_update`` reads.
"""
from __future__ import annotations

import torch

from ..core.dag import Mode, TaskGraph
from ..kernels.tile_gemm import gemm_update
from .tiles import make_tile_objects


def _potrf(a_kk):
    # jnp.linalg.cholesky symmetrizes its input first; so does this body
    return (torch.linalg.cholesky((a_kk + a_kk.T) / 2).contiguous(),)


def _trsm(l_kk, a_ik):
    # A[i,k] <- A[i,k] * L[k,k]^{-T}
    x = torch.linalg.solve_triangular(l_kk, a_ik.T, upper=False)
    return (x.T.contiguous(),)


def _syrk(a_ik, a_ii):
    return (gemm_update(a_ii, a_ik, a_ik, alpha=-1.0, trans_b=True),)


def _gemm(a_ik, a_jk, a_ij):
    return (gemm_update(a_ij, a_ik, a_jk, alpha=-1.0, trans_b=True),)


def cholesky_graph(
    n_tiles: int, tile: int = 512, itemsize: int = 8, with_fns: bool = True
) -> TaskGraph:
    """Build the tile-Cholesky DAG for an (n_tiles*tile)^2 matrix."""
    g = TaskGraph()
    A = make_tile_objects("A", n_tiles, tile, itemsize)
    b3 = float(tile) ** 3
    fns = with_fns
    for k in range(n_tiles):
        g.add_task("potrf", [(A[(k, k)], Mode.RW)], flops=b3 / 3.0,
                   fn=_potrf if fns else None, tag=("potrf", k))
        for i in range(k + 1, n_tiles):
            g.add_task(
                "trsm",
                [(A[(k, k)], Mode.R), (A[(i, k)], Mode.RW)],
                flops=b3,
                fn=_trsm if fns else None,
                tag=("trsm", i, k),
            )
        for i in range(k + 1, n_tiles):
            g.add_task(
                "syrk",
                [(A[(i, k)], Mode.R), (A[(i, i)], Mode.RW)],
                flops=b3,
                fn=_syrk if fns else None,
                tag=("syrk", i, k),
            )
            for j in range(k + 1, i):
                g.add_task(
                    "gemm",
                    [
                        (A[(i, k)], Mode.R),
                        (A[(j, k)], Mode.R),
                        (A[(i, j)], Mode.RW),
                    ],
                    flops=2.0 * b3,
                    fn=_gemm if fns else None,
                    tag=("gemm", i, j, k),
                )
    return g
