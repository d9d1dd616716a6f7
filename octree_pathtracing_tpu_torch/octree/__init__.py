"""Host-side octree builder (numpy): dense voxel grid -> node pool."""

from .build import build_from_dense, build_octree_from_codes
from .morton import morton_order_dense
from .node_pool import Octree

__all__ = ["Octree", "build_from_dense", "build_octree_from_codes", "morton_order_dense"]
