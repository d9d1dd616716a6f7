"""Morton (Z-order) flattening of a dense voxel grid (copy of the part of
``octree_pathtracing_tpu/octree/morton.py`` that the builder needs)."""

from __future__ import annotations

import numpy as np


def morton_order_dense(grid: np.ndarray) -> np.ndarray:
    """Flatten a dense ``(S, S, S)`` grid (indexed ``[x, y, z]``) into Morton
    order without computing per-voxel codes.

    A 2^d cube in Morton order is a pure axis permutation: view the grid as
    ``(2,)*3d`` with x-bits, y-bits, z-bits as separate axes, then interleave
    the axes most-significant-first as (z_b, y_b, x_b) per level.  The child
    slot within an octant is then ``x | y << 1 | z << 2``.
    """
    s = grid.shape[0]
    if grid.shape != (s, s, s):
        raise ValueError("grid must be a cube")
    d = int(s).bit_length() - 1
    if (1 << d) != s:
        raise ValueError("grid side must be a power of two")
    if d == 0:
        return grid.reshape(-1)
    # axes: x-bits [0..d), y-bits [d..2d), z-bits [2d..3d), each MSB-first.
    v = grid.reshape((2,) * (3 * d))
    # output axis order: level 0 (most significant octant digit) = (z0, y0, x0), ...
    perm = []
    for lvl in range(d):
        perm.extend([2 * d + lvl, d + lvl, lvl])
    return v.transpose(perm).reshape(-1)
