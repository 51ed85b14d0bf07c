"""Tiled-matrix helpers (PLASMA-style square tiles)."""
from __future__ import annotations

from typing import Dict, Tuple

from ..core.dag import DataObject


def tile_name(label: str, i: int, j: int) -> str:
    return f"{label}[{i},{j}]"


def make_tile_objects(
    label: str, n_tiles: int, tile: int, itemsize: int = 8
) -> Dict[Tuple[int, int], DataObject]:
    """DataObjects for an n_tiles x n_tiles tiled matrix."""
    objs = {}
    for i in range(n_tiles):
        for j in range(n_tiles):
            objs[(i, j)] = DataObject(
                name=tile_name(label, i, j),
                size_bytes=tile * tile * itemsize,
                meta=(label, i, j),
            )
    return objs
