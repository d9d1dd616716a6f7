"""octree_pathtracing_tpu_torch — the sparse-voxel-octree path tracer in
PyTorch, with its traversal written by hand in CUDA for Hopper (sm_90a).

A port of ``octree_pathtracing_tpu`` (the JAX package, which stays the
reference).  The layout mirrors it module for module:

- ``octree`` : the numpy octree builder (dense grid -> node pool), leaf
               enumeration, voxel edits, the node and Morton codecs
- ``ops``    : ESVO traversal in four modes and its block-model variant
               (CUDA kernels + plain-torch twins), Philox uniforms and the
               row gather (CUDA kernels + twins), quad and sphere geometry,
               BRDF sampling, texture atlas
- ``models`` : scene tables as dataclasses of tensors — camera, sun,
               materials, block models, analytic primitives (the K7 kernel
               + twin), the emitter table, procedural scenes, conversion
               from the JAX scene
- ``render`` : hit resolution, wavefront path tracer, progressive renderer,
               the flat-shaded preview (its shading kernel K10 in
               ``ops/preview.py``), test images
- ``diff``   : relaxed-visibility (soft) radiance and inverse rendering
- ``parallel``: the sharded render and train step over
               ``torch.distributed`` (a (dp, sp) grid of ranks)
- ``io``     : image output (PNG through PIL when present, PPM otherwise),
               render and array checkpoints
- ``utils``  : JSON-line metrics, the nvcc build, math / bit / colour
               helpers

Nothing in this package imports ``jax`` or the JAX package.
"""

import os

__version__ = "0.1.0"

# Kernel builds and the scene cache live here (listed in .gitignore).
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build"
)
