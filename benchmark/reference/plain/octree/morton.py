"""Morton (Z-order) codes, their inverse, and the Morton flattening of a
dense voxel grid (copy of the host codecs of
``octree_pathtracing_tpu/octree/morton.py``): 64-bit numpy codes of up to
21 bits per axis."""

from __future__ import annotations

import numpy as np

_M64 = [
    np.uint64(0x1FFFFF),
    np.uint64(0x1F00000000FFFF),
    np.uint64(0x1F0000FF0000FF),
    np.uint64(0x100F00F00F00F00F),
    np.uint64(0x10C30C30C30C30C3),
    np.uint64(0x1249249249249249),
]


def part_by_2(v: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of each element so they occupy every 3rd bit."""
    x = np.asarray(v, dtype=np.uint64) & _M64[0]
    x = (x | (x << np.uint64(32))) & _M64[1]
    x = (x | (x << np.uint64(16))) & _M64[2]
    x = (x | (x << np.uint64(8))) & _M64[3]
    x = (x | (x << np.uint64(4))) & _M64[4]
    x = (x | (x << np.uint64(2))) & _M64[5]
    return x


def compact_by_2(v: np.ndarray) -> np.ndarray:
    """Inverse of :func:`part_by_2`: gather every 3rd bit into the low 21."""
    x = np.asarray(v, dtype=np.uint64) & _M64[5]
    x = (x | (x >> np.uint64(2))) & _M64[4]
    x = (x | (x >> np.uint64(4))) & _M64[3]
    x = (x | (x >> np.uint64(8))) & _M64[2]
    x = (x | (x >> np.uint64(16))) & _M64[1]
    x = (x | (x >> np.uint64(32))) & _M64[0]
    return x


def encode_morton(x, y, z) -> np.ndarray:
    """Interleave three <= 21-bit coordinates into a Morton code: z takes the
    high bit of each triple, then y, then x (the child slot within an octant
    is ``x | y << 1 | z << 2``)."""
    return (part_by_2(z) << np.uint64(2)) | (part_by_2(y) << np.uint64(1)) | part_by_2(x)


def decode_morton(code) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x, y, z): the inverse of :func:`encode_morton`."""
    c = np.asarray(code, dtype=np.uint64)
    return compact_by_2(c), compact_by_2(c >> np.uint64(1)), compact_by_2(c >> np.uint64(2))


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
