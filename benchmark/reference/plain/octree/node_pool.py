"""Flat sparse-voxel-octree node pool as the host builder emits it (copy of
``Octree`` from ``octree_pathtracing_tpu/octree/node_pool.py``).

- ``child_mask (N,) uint32`` — low 8 bits: child present; bits 8..15: leaf
  flag.
- ``child_data (N, 8) uint32`` — per-slot child octant index or leaf value.

Child slot index within an octant is ``x | y<<1 | z<<2`` (Morton digit).  A
leaf value of 0 is reserved for air.  ``ops.traversal.pack_nodes`` turns the
two arrays into the ``(N, 8)`` int32 table the traversal reads.

The reference's 12-word GPU node format (words 0-3: eight 16-bit headers,
words 4-11: the child data) is kept for interchange: a header is 0x0000
for an empty slot, ``CHILD_BIT`` (0x2) for an interior child and 0xFFFF for
a leaf; a consumer tests ``header == 0xFFFF`` for a leaf and
``(header & 255) != 0`` for presence.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LEAF_BIT = 0x1
CHILD_BIT = 0x2
LOD_BIT = 0x4
LEAF_HEADER = 0xFFFF


@dataclasses.dataclass
class Octree:
    """A built octree: node pool + root + depth.  ``scale() = 2^-depth``
    maps world voxel units into the traversal's [1, 2) cube."""

    child_mask: np.ndarray  # (N,) uint32
    child_data: np.ndarray  # (N, 8) uint32
    root: int
    depth: int

    def scale(self) -> float:
        return float(2.0 ** (-self.depth))

    @property
    def n_nodes(self) -> int:
        return int(self.child_mask.shape[0])


def is_child(child_mask: np.ndarray, slot) -> np.ndarray:
    return (child_mask >> slot) & 1


def is_leaf(child_mask: np.ndarray, slot) -> np.ndarray:
    return (child_mask >> (slot + 8)) & 1


def octree_to_gpu_words(tree: Octree) -> np.ndarray:
    """The pool in the reference's 12-word node format, (N, 12) uint32."""
    mask = np.asarray(tree.child_mask, dtype=np.uint32)
    data = np.asarray(tree.child_data, dtype=np.uint32)
    n = mask.shape[0]
    slots = np.arange(8, dtype=np.uint32)
    present = (mask[:, None] >> slots[None, :]) & 1
    leaf = (mask[:, None] >> (slots[None, :] + 8)) & 1
    headers = np.where(
        leaf != 0,
        np.uint32(LEAF_HEADER),
        np.where(present != 0, np.uint32(CHILD_BIT), np.uint32(0)),
    ).astype(np.uint32)
    words = np.zeros((n, 12), dtype=np.uint32)
    words[:, 0:4] = headers[:, 0::2] | (headers[:, 1::2] << np.uint32(16))
    words[:, 4:12] = data
    return words


def gpu_words_to_pool(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(child_mask, child_data) of 12-word nodes: the inverse of
    :func:`octree_to_gpu_words`."""
    words = np.asarray(words, dtype=np.uint32)
    headers = np.zeros((words.shape[0], 8), dtype=np.uint32)
    headers[:, 0::2] = words[:, 0:4] & np.uint32(0xFFFF)
    headers[:, 1::2] = words[:, 0:4] >> np.uint32(16)
    present = (headers & np.uint32(0xFF)) != 0
    leaf = headers == np.uint32(LEAF_HEADER)
    slots = np.arange(8, dtype=np.uint32)
    mask = (
        np.sum(present.astype(np.uint32) << slots[None, :], axis=1)
        | np.sum(leaf.astype(np.uint32) << (slots[None, :] + 8), axis=1)
    ).astype(np.uint32)
    return mask, words[:, 4:12].copy()
