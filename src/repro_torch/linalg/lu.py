"""Tile LU (PLASMA DGETRF task shape) as a data-flow task graph.

Task kinds / flop counts (tile size b):
  getrf  2/3 b^3    gessm  b^3     tstrf  b^3     ssssm  2 b^3
Total ~ 2 n^3 / 3.
"""
from __future__ import annotations

from ..core.dag import Mode, TaskGraph
from .tiles import make_tile_objects


def lu_graph(n_tiles: int, tile: int = 512, itemsize: int = 8) -> TaskGraph:
    g = TaskGraph()
    A = make_tile_objects("A", n_tiles, tile, itemsize)
    b3 = float(tile) ** 3
    for k in range(n_tiles):
        g.add_task("getrf", [(A[(k, k)], Mode.RW)], flops=2.0 * b3 / 3.0,
                   tag=("getrf", k))
        for j in range(k + 1, n_tiles):
            g.add_task(
                "gessm",
                [(A[(k, k)], Mode.R), (A[(k, j)], Mode.RW)],
                flops=b3,
                tag=("gessm", k, j),
            )
        for i in range(k + 1, n_tiles):
            g.add_task(
                "tstrf",
                [(A[(k, k)], Mode.R), (A[(i, k)], Mode.RW)],
                flops=b3,
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
                    tag=("ssssm", i, j, k),
                )
    return g
