"""Host-side octree builders (numpy): sparse voxels or a dense grid -> node
pool; leaf enumeration."""

from .build import build_from_dense, build_octree, build_octree_from_codes, expand_by
from .leaves import enumerate_leaves, unpack_nodes
from .morton import encode_morton, morton_order_dense
from .node_pool import Octree

__all__ = [
    "Octree",
    "build_from_dense",
    "build_octree",
    "build_octree_from_codes",
    "encode_morton",
    "expand_by",
    "enumerate_leaves",
    "morton_order_dense",
    "unpack_nodes",
]
