"""Vectorized SVO builders: sparse voxels or a dense grid -> compacted node
pool (copy of ``build_octree``, ``build_octree_from_codes``,
``build_from_dense`` and ``expand_by`` from
``octree_pathtracing_tpu/octree/build.py``).

One bottom-up level reduction over Morton-sorted voxels: each level groups
codes by ``code >> 3``, scatters the <= 8 children of each group into
``(G, 8)`` arrays, applies the compaction rule (an octant collapses to one
leaf iff all 8 slots are leaves holding the same value) and appends the
surviving octants to the pool.  O(levels) numpy passes.
"""

from __future__ import annotations

import numpy as np

from .morton import encode_morton, morton_order_dense
from .node_pool import Octree

_EMPTY, _LEAF, _OCTANT = 0, 1, 2


def build_octree(coords: np.ndarray, values: np.ndarray, depth: int) -> Octree:
    """Build a compacted SVO from sparse voxels: ``coords`` (M, 3) integer
    voxel coordinates in ``[0, 2**depth)``, ``values`` (M,) uint32 leaf
    values (0, air, is dropped).  Duplicate coordinates keep the last value
    written."""
    coords = np.asarray(coords, dtype=np.int64)
    values = np.asarray(values, dtype=np.uint32)
    keep = values != 0
    coords, values = coords[keep], values[keep]
    codes = encode_morton(coords[:, 0], coords[:, 1], coords[:, 2])
    order = np.argsort(codes, kind="stable")
    codes, values = codes[order], values[order]
    # deduplicate, keeping the last occurrence of each code
    last = np.ones(codes.shape[0], dtype=bool)
    last[:-1] = codes[:-1] != codes[1:]
    return build_octree_from_codes(codes[last], values[last], depth)


def build_octree_from_codes(codes: np.ndarray, values: np.ndarray, depth: int) -> Octree:
    """Build from sorted, unique Morton codes and their nonzero leaf values."""
    codes = np.asarray(codes, dtype=np.uint64)
    values = np.asarray(values, dtype=np.uint32)
    if codes.size == 0:
        # empty world: a root with no children; every ray misses
        return Octree(
            child_mask=np.zeros((1,), np.uint32),
            child_data=np.zeros((1, 8), np.uint32),
            root=0,
            depth=depth,
        )

    masks: list[np.ndarray] = []
    datas: list[np.ndarray] = []
    pool_size = 0

    types = np.full(codes.shape[0], _LEAF, dtype=np.uint8)
    vals = values
    for _level in range(depth, 0, -1):
        parent = codes >> np.uint64(3)
        slot = (codes & np.uint64(7)).astype(np.int64)
        # group boundaries on the sorted parent stream
        if parent.shape[0] == 1:
            start = np.zeros(1, np.int64)
        else:
            start = np.concatenate(
                [np.zeros(1, np.int64), np.flatnonzero(parent[1:] != parent[:-1]) + 1]
            )
        uniq = parent[start]
        g = uniq.shape[0]
        group_id = np.repeat(
            np.arange(g, dtype=np.int64), np.diff(np.append(start, codes.shape[0]))
        )
        data8 = np.zeros((g, 8), dtype=np.uint32)
        type8 = np.zeros((g, 8), dtype=np.uint8)
        data8[group_id, slot] = vals
        type8[group_id, slot] = types

        all_leaf = np.all(type8 == _LEAF, axis=1)
        all_equal = np.all(data8 == data8[:, :1], axis=1)
        collapse = all_leaf & all_equal

        kept = ~collapse
        kept_ids = pool_size + np.cumsum(kept) - 1  # pool index per kept group

        k_mask = (
            np.sum((type8[kept] != _EMPTY).astype(np.uint32) << np.arange(8, dtype=np.uint32), axis=1)
            | np.sum(
                (type8[kept] == _LEAF).astype(np.uint32) << (np.arange(8, dtype=np.uint32) + 8),
                axis=1,
            )
        ).astype(np.uint32)
        masks.append(k_mask)
        datas.append(data8[kept])
        pool_size += int(kept.sum())

        codes = uniq
        vals = np.where(collapse, data8[:, 0], kept_ids.astype(np.uint32)).astype(np.uint32)
        types = np.where(collapse, np.uint8(_LEAF), np.uint8(_OCTANT))

    # after the loop there is exactly one level-0 entry: the root
    if types[0] == _OCTANT:
        root = int(vals[0])
    else:
        # the whole world is one value: an all-leaf root octant
        masks.append(np.array([0xFFFF], dtype=np.uint32))
        datas.append(np.full((1, 8), vals[0], dtype=np.uint32))
        root = pool_size
        pool_size += 1

    return Octree(
        child_mask=np.concatenate(masks) if masks else np.zeros((1,), np.uint32),
        child_data=np.concatenate(datas) if datas else np.zeros((1, 8), np.uint32),
        root=root,
        depth=depth,
    )


def build_from_dense(grid: np.ndarray) -> Octree:
    """Build from a dense ``(S, S, S)`` uint32 grid indexed ``[x, y, z]``
    (0 is air, ``S`` a power of two)."""
    grid = np.asarray(grid, dtype=np.uint32)
    mvals = morton_order_dense(grid)
    depth = int(grid.shape[0]).bit_length() - 1
    codes = np.flatnonzero(mvals).astype(np.uint64)
    # Morton-order flattening emits codes already sorted and unique
    return build_octree_from_codes(codes, mvals[codes], depth)


def expand_by(tree: Octree, extra_depth: int) -> Octree:
    """Wrap the root in ``extra_depth`` new roots, the old tree at child slot
    0: each wrap doubles the world's side, the content staying in the low
    corner octant."""
    mask = np.asarray(tree.child_mask, np.uint32)
    data = np.asarray(tree.child_data, np.uint32)
    root = tree.root
    for _ in range(extra_depth):
        new_mask = np.concatenate([mask, np.array([0x01], np.uint32)])  # slot 0, interior
        new_row = np.zeros((1, 8), np.uint32)
        new_row[0, 0] = root
        data = np.concatenate([data, new_row])
        root = mask.shape[0]
        mask = new_mask
    return Octree(mask, data, root, tree.depth + extra_depth)
