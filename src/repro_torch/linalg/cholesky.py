"""Tile Cholesky (PLASMA DPOTRF, right-looking) as a data-flow task graph.

Task kinds / flop counts (tile size b):
  potrf  b^3/3      trsm  b^3      syrk  b^3      gemm  2 b^3
Total ~ n^3/3 for an n x n matrix — the standard Cholesky count the paper's
GFLOPS plots use. The graph carries no tile bodies: it is what the
scheduler sees.
"""
from __future__ import annotations

from ..core.dag import Mode, TaskGraph
from .tiles import make_tile_objects


def cholesky_graph(n_tiles: int, tile: int = 512, itemsize: int = 8) -> TaskGraph:
    """Build the tile-Cholesky DAG for an (n_tiles*tile)^2 matrix."""
    g = TaskGraph()
    A = make_tile_objects("A", n_tiles, tile, itemsize)
    b3 = float(tile) ** 3
    for k in range(n_tiles):
        g.add_task("potrf", [(A[(k, k)], Mode.RW)], flops=b3 / 3.0,
                   tag=("potrf", k))
        for i in range(k + 1, n_tiles):
            g.add_task(
                "trsm",
                [(A[(k, k)], Mode.R), (A[(i, k)], Mode.RW)],
                flops=b3,
                tag=("trsm", i, k),
            )
        for i in range(k + 1, n_tiles):
            g.add_task(
                "syrk",
                [(A[(i, k)], Mode.R), (A[(i, i)], Mode.RW)],
                flops=b3,
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
                    tag=("gemm", i, j, k),
                )
    return g
