"""Tile QR (PLASMA DGEQRF, flat reduction tree) as a data-flow task graph.

Task kinds / flop counts (tile size b):
  geqrt  4/3 b^3   ormqr  2 b^3   tsqrt  10/3 b^3   tsmqr  4 b^3
Leading-order total ~ 4 n^3 / 3 (tsmqr dominates). The T tiles have
PLASMA's sizes (ib x b), so simulated transfer volumes stay faithful.
"""
from __future__ import annotations

from ..core.dag import DataObject, Mode, TaskGraph
from .tiles import make_tile_objects, tile_name


def qr_graph(
    n_tiles: int, tile: int = 512, inner_block: int = 128, itemsize: int = 8
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
    for k in range(n_tiles):
        g.add_task(
            "geqrt",
            [(A[(k, k)], Mode.RW), (T[(k, k)], Mode.W)],
            flops=4.0 * b3 / 3.0,
            tag=("geqrt", k),
        )
        for j in range(k + 1, n_tiles):
            g.add_task(
                "ormqr",
                [(T[(k, k)], Mode.R), (A[(k, j)], Mode.RW)],
                flops=2.0 * b3,
                tag=("ormqr", k, j),
            )
        for i in range(k + 1, n_tiles):
            g.add_task(
                "tsqrt",
                [(A[(k, k)], Mode.RW), (A[(i, k)], Mode.RW), (T[(i, k)], Mode.W)],
                flops=10.0 * b3 / 3.0,
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
                    tag=("tsmqr", i, j, k),
                )
    return g
