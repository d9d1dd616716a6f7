"""Voxel edits on the host pool (port of ``octree/edit.py``, numpy as
there): set, get and remove single voxels of a built octree, descending
from the root, allocating nodes on demand, splitting a coarse leaf into 8
children when an edit lands below it, and compacting upward when siblings
become uniform.  Edit between renders, then rebuild the scene from
:meth:`EditableOctree.to_octree` (``models.convert.scene_from_numpy`` or
``models.scene.make_scene``)."""

from __future__ import annotations

import numpy as np

from .node_pool import Octree


class EditableOctree:
    """A mutable copy of an octree's pool."""

    def __init__(self, tree: Octree):
        self.mask = np.asarray(tree.child_mask, np.uint32).copy()
        self.data = np.asarray(tree.child_data, np.uint32).copy()
        self.root = int(tree.root)
        self.depth = int(tree.depth)

    def to_octree(self) -> Octree:
        return Octree(self.mask.copy(), self.data.copy(), self.root, self.depth)

    def _alloc(self) -> int:
        nid = self.mask.shape[0]
        self.mask = np.append(self.mask, np.uint32(0))
        self.data = np.vstack([self.data, np.zeros((1, 8), np.uint32)])
        return nid

    @staticmethod
    def _slot(x, y, z, level):
        return ((x >> level) & 1) | (((y >> level) & 1) << 1) | (((z >> level) & 1) << 2)

    def get(self, x: int, y: int, z: int) -> int:
        node = self.root
        for level in range(self.depth - 1, -1, -1):
            s = self._slot(x, y, z, level)
            m = int(self.mask[node])
            if not (m >> s) & 1:
                return 0
            v = int(self.data[node, s])
            if (m >> (s + 8)) & 1:
                return v
            node = v
        raise AssertionError("malformed pool")

    def set(self, x: int, y: int, z: int, value: int) -> None:
        """Set one voxel (0 removes it): split coarse leaves on the way
        down, compact uniform octants on the way up."""
        path = []
        node = self.root
        for level in range(self.depth - 1, 0, -1):
            s = self._slot(x, y, z, level)
            path.append((node, s))
            m = int(self.mask[node])
            present = (m >> s) & 1
            leaf = (m >> (s + 8)) & 1
            if present and not leaf:
                node = int(self.data[node, s])
                continue
            # allocate a child octant; where the slot was a coarse leaf, fill
            # the new octant with 8 copies of its value (the split)
            child = self._alloc()
            if present and leaf:
                fill = self.data[node, s]
                self.mask[child] = np.uint32(0xFFFF)
                self.data[child, :] = fill
            # the slot becomes interior: present bit set, leaf bit cleared
            mm = int(self.mask[node])
            mm |= 1 << s
            mm &= ~(1 << (s + 8))
            self.mask[node] = np.uint32(mm)
            self.data[node, s] = child
            node = child
        # the leaf level
        s = self._slot(x, y, z, 0)
        mm = int(self.mask[node])
        if value == 0:
            mm &= ~(1 << s)
            mm &= ~(1 << (s + 8))
            self.data[node, s] = 0
        else:
            mm |= (1 << s) | (1 << (s + 8))
            self.data[node, s] = value
        self.mask[node] = np.uint32(mm)
        # upward compaction: an empty octant leaves its parent's slot, a
        # uniform all-leaf octant collapses into it
        for pnode, ps in reversed(path):
            cm = int(self.mask[node])
            if cm == 0:
                pm = int(self.mask[pnode])
                pm &= ~(1 << ps)
                pm &= ~(1 << (ps + 8))
                self.mask[pnode] = np.uint32(pm)
                self.data[pnode, ps] = 0
            elif cm == 0xFFFF and np.all(self.data[node] == self.data[node, 0]):
                pm = int(self.mask[pnode])
                pm |= (1 << ps) | (1 << (ps + 8))
                self.mask[pnode] = np.uint32(pm)
                self.data[pnode, ps] = self.data[node, 0]
            else:
                break
            node = pnode

    def remove(self, x: int, y: int, z: int) -> None:
        self.set(x, y, z, 0)
