"""Flat sparse-voxel-octree node pool as the host builder emits it (copy of
``Octree`` from ``octree_pathtracing_tpu/octree/node_pool.py``).

- ``child_mask (N,) uint32`` — low 8 bits: child present; bits 8..15: leaf
  flag.
- ``child_data (N, 8) uint32`` — per-slot child octant index or leaf value.

Child slot index within an octant is ``x | y<<1 | z<<2`` (Morton digit).  A
leaf value of 0 is reserved for air.  ``ops.traversal.pack_nodes`` turns the
two arrays into the ``(N, 8)`` int32 table the traversal reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
