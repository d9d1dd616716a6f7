"""Host-side leaf enumeration over a node pool (numpy), and the node pool of
a packed node table.

A vectorised top-down sweep, one numpy pass per level: at scene-build time
it lists the leaf cells from which the emissive-leaf table of emitter
sampling is built (``models/emitters.build_emitter_table``).  Child slot
convention of the Morton builder (``octree/morton.py``): slot = x | y<<1 |
z<<2 within the parent's cell.
"""

from __future__ import annotations

import numpy as np

VALUE_MASK = 0x3FFFFFFF  # the packed table's low 30 bits: child index / leaf value


def enumerate_leaves(child_mask, child_data, root: int, depth: int):
    """All leaf cells of the tree, including LOD-collapsed ones.

    Returns ``(pos (M, 3) int64, size (M,) int64, value (M,) uint32)`` where
    ``pos`` is the cell's min corner in voxel units ``[0, 2**depth)`` and
    ``size`` its side length (1 for bottom-level leaves, larger for collapsed
    octants).
    """
    mask = np.asarray(child_mask, np.uint32)
    data = np.asarray(child_data, np.uint32)
    slots = np.arange(8, dtype=np.uint32)
    off = np.stack([slots & 1, (slots >> 1) & 1, (slots >> 2) & 1], axis=1).astype(np.int64)  # (8, 3)

    nodes = np.array([root], np.int64)
    pos = np.zeros((1, 3), np.int64)
    size = np.int64(1 << depth)

    out_pos, out_size, out_val = [], [], []
    for _level in range(depth):
        half = size >> 1
        m = mask[nodes]  # (F,)
        present = ((m[:, None] >> slots) & 1) != 0  # (F, 8)
        leaf = ((m[:, None] >> (slots + 8)) & 1) != 0
        cpos = pos[:, None, :] + off[None, :, :] * half  # (F, 8, 3)
        vals = data[nodes]  # (F, 8)

        is_leaf = present & leaf
        if is_leaf.any():
            out_pos.append(cpos[is_leaf])
            out_size.append(np.full(int(is_leaf.sum()), half, np.int64))
            out_val.append(vals[is_leaf])

        is_int = present & ~leaf
        nodes = vals[is_int].astype(np.int64)
        pos = cpos[is_int]
        size = half
        if nodes.size == 0:
            break

    if not out_pos:
        return np.zeros((0, 3), np.int64), np.zeros((0,), np.int64), np.zeros((0,), np.uint32)
    return np.concatenate(out_pos), np.concatenate(out_size), np.concatenate(out_val)


def unpack_nodes(nodes_packed):
    """(N, 8) packed int32 table (``ops/traversal.pack_nodes``) -> numpy
    ``(child_mask (N,) uint32, child_data (N, 8) uint32)``: present bits in
    0-7, leaf bits in 8-15, the 30-bit values."""
    words = np.asarray(nodes_packed).astype(np.int32).view(np.uint32)
    slots = np.arange(8, dtype=np.uint32)
    present = (words >> 30) & 1
    leaf = words >> 31
    mask = ((present << slots) | (leaf << (slots + 8))).sum(axis=1, dtype=np.uint32)
    return mask, words & VALUE_MASK
