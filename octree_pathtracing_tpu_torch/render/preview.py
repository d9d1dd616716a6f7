"""Flat-shaded preview renderer (port of ``render/preview.py``), the
reference's preview mode: the primary walk, then per pixel the hit's
texel forced opaque, shaded by ``max(AMBIENT, n . sun_dir)`` times the
sun's emittance, or on a miss the sky and the sun's window.

The walk is the scene's first-hit traversal (``pathtracer._trace``: K1 on
all-opaque scenes, K2 with the alpha accept otherwise, K2q on scenes with
block models), the shading kernel K10 (``ops/preview.preview_shade``).  Like
the JAX preview it walks the octree only: analytic primitives are not
drawn.
"""

from __future__ import annotations

from ..models.camera import Camera, pixel_grid_rays
from ..models.scene import Scene
from ..ops.preview import preview_shade
from .pathtracer import _trace


def preview_render_rays(scene: Scene, origins, directions):
    """Preview-shade a ray batch; returns (B, 3) linear RGB."""
    res = _trace(scene, origins, directions)
    return preview_shade(scene, directions, res)


def preview_image(scene: Scene, camera: Camera, width: int, height: int):
    """Render a full-frame preview; returns (H, W, 3) linear RGB on the
    scene's device."""
    origins, dirs = pixel_grid_rays(camera, width, height)
    return preview_render_rays(scene, origins, dirs).reshape(height, width, 3)
