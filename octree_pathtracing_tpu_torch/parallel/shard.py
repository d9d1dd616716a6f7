"""Trainable parameters grafted into a scene, and the photometric loss over
them (port of ``apply_params`` and ``render_loss`` of
``parallel/shard.py``).  The sharded render and train steps are not ported
yet (ROADMAP queue 1, item 10)."""

from __future__ import annotations

import dataclasses

import torch

from ..models.scene import Scene
from ..ops.texture import Atlas
from ..render.pathtracer import trace_paths


def apply_params(scene: Scene, params: dict) -> Scene:
    """Graft trainable leaves (atlas albedo, material emittance) into a scene.

    ``params["atlas"]`` is either a full atlas (tensor or :class:`Atlas`)
    or, for a variable-resolution scene, just the texel ``data`` tensor (the
    int size table is structural, not trainable).  The scene's
    ``opaque_only`` and ``shadow_binary`` stay as they were built: the
    traversal structure does not follow the trained alphas."""
    atlas = params["atlas"]
    if isinstance(scene.atlas, Atlas) and not isinstance(atlas, Atlas):
        atlas = Atlas(atlas, scene.atlas.sizes)
    materials = dataclasses.replace(scene.materials, emittance=params["emittance"])
    return dataclasses.replace(scene, atlas=atlas, materials=materials)


def render_loss(scene: Scene, params: dict, origins, dirs, uniforms, target) -> torch.Tensor:
    """Photometric MSE with trainable (atlas, emittance) grafted into the
    scene — the inverse-rendering objective."""
    rad = trace_paths(apply_params(scene, params), origins, dirs, uniforms)
    return torch.mean((rad - target) ** 2)
