"""octree_pathtracing_tpu_torch — the sparse-voxel-octree path tracer in
PyTorch, with its traversal written by hand in CUDA for Hopper (sm_90a).

A port of ``octree_pathtracing_tpu`` (the JAX package, which stays the
reference).  The layout mirrors it module for module:

- ``octree`` : the numpy octree builder (dense grid -> node pool), leaf
               enumeration
- ``ops``    : ESVO traversal in four modes (CUDA kernels + plain-torch
               twins), Philox uniforms and the row gather (CUDA kernels +
               twins), BRDF sampling, texture atlas
- ``models`` : scene tables as dataclasses of tensors — camera, sun,
               materials, the emitter table, procedural scenes, conversion
               from the JAX scene
- ``render`` : hit resolution, wavefront path tracer, progressive renderer
- ``diff``   : relaxed-visibility (soft) radiance and inverse rendering
- ``parallel``: grafting trainable parameters into a scene
- ``io``     : image output (PNG through PIL when present, PPM otherwise),
               array checkpoints
- ``utils``  : JSON-line metrics, the nvcc build

Nothing in this package imports ``jax`` or the JAX package.
"""

import os

__version__ = "0.1.0"

# Kernel builds and the scene cache live here (listed in .gitignore).
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build"
)
