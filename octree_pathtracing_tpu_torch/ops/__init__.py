from .random import philox_uniforms, philox_uniforms_reference
from .traversal import (
    AlphaTables,
    HitResult,
    SurfaceRecord,
    pack_nodes,
    traverse,
    traverse_alpha,
    traverse_alpha_reference,
    traverse_record,
    traverse_record_reference,
    traverse_reference,
)

__all__ = [
    "AlphaTables",
    "HitResult",
    "SurfaceRecord",
    "pack_nodes",
    "philox_uniforms",
    "philox_uniforms_reference",
    "traverse",
    "traverse_alpha",
    "traverse_alpha_reference",
    "traverse_record",
    "traverse_record_reference",
    "traverse_reference",
]
