"""Host-side octree builder (numpy): dense voxel grid -> node pool; leaf
enumeration."""

from .build import build_from_dense, build_octree_from_codes
from .leaves import enumerate_leaves, unpack_nodes
from .morton import morton_order_dense
from .node_pool import Octree

__all__ = [
    "Octree",
    "build_from_dense",
    "build_octree_from_codes",
    "enumerate_leaves",
    "morton_order_dense",
    "unpack_nodes",
]
