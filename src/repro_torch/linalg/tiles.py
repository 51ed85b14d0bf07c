"""Tiled-matrix helpers (PLASMA-style square tiles).

Counterpart of ``repro.linalg.tiles``. The ``random_*`` test matrices are
drawn with numpy's ``default_rng(seed)`` exactly as the reference draws
them, in f64, and only then converted, so both packages start from the
same numbers.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.dag import DataObject
from ..device import resolve_device


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


def split_tiles(a: torch.Tensor, tile: int) -> Dict[str, torch.Tensor]:
    """Split a square matrix into named tiles A[i,j]. The tiles are views
    of ``a`` (the tile bodies never write into their inputs)."""
    n = a.shape[0]
    if a.shape != (n, n) or n % tile:
        raise ValueError(f"need a square matrix tiled evenly by {tile}, got {tuple(a.shape)}")
    nt = n // tile
    return {
        tile_name("A", i, j): a[i * tile : (i + 1) * tile, j * tile : (j + 1) * tile]
        for i in range(nt)
        for j in range(nt)
    }


def join_tiles(tiles: Dict[str, torch.Tensor], nt: int, tile: int) -> torch.Tensor:
    """The (nt*tile)^2 matrix of the tiles A[i,j]."""
    return torch.cat(
        [torch.cat([tiles[tile_name("A", i, j)] for j in range(nt)], dim=1) for i in range(nt)],
        dim=0,
    )


def _to_torch(x: np.ndarray, dtype, device) -> torch.Tensor:
    # The reference's default dtype is jnp.float64, which JAX without x64
    # turns into float32, so the tile numerics run f32 by default here.
    # The cast rounds to nearest on the host, as numpy's does.
    return torch.from_numpy(x).to(dtype or torch.float32).to(resolve_device(device))


def random_spd(n: int, seed: int = 0, dtype=None, device="cuda") -> torch.Tensor:
    """Symmetric positive-definite test matrix."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    spd = a @ a.T / n + np.eye(n) * n
    return _to_torch(spd, dtype, device)


def random_dd(n: int, seed: int = 0, dtype=None, device="cuda") -> torch.Tensor:
    """Diagonally-dominant matrix (safe for no-pivot LU)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a = a + np.eye(n) * (np.abs(a).sum(axis=1).max() + n)
    return _to_torch(a, dtype, device)


def random_dense(n: int, seed: int = 0, dtype=None, device="cuda") -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return _to_torch(rng.standard_normal((n, n)), dtype, device)
