"""Host-side octree builders (numpy): sparse voxels or a dense grid -> node
pool; leaf enumeration; voxel edits; the Morton and 12-word node codecs."""

from .build import build_from_dense, build_octree, build_octree_from_codes, expand_by
from .edit import EditableOctree
from .leaves import enumerate_leaves, unpack_nodes
from .morton import compact_by_2, decode_morton, encode_morton, morton_order_dense, part_by_2
from .node_pool import Octree, gpu_words_to_pool, is_child, is_leaf, octree_to_gpu_words

__all__ = [
    "EditableOctree",
    "Octree",
    "compact_by_2",
    "decode_morton",
    "gpu_words_to_pool",
    "is_child",
    "is_leaf",
    "octree_to_gpu_words",
    "part_by_2",
    "build_from_dense",
    "build_octree",
    "build_octree_from_codes",
    "encode_morton",
    "expand_by",
    "enumerate_leaves",
    "morton_order_dense",
    "unpack_nodes",
]
