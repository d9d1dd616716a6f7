"""Scene — packed octree + material table + texture atlas + sun + block
models + analytic primitives + emitter table + strategy flags (port of
``models/scene.py``).

The octree lives as the packed ``(N, 8)`` int32 node table of
:func:`ops.traversal.pack_nodes` (flags in the child words), which is what
the traversal kernel reads.  ``scene.to(device)`` moves every table.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops.texture import Atlas
from ..ops.traversal import FLAG_SIMPLE, pack_nodes
from .materials import MaterialTable
from .sun import Sun, SunSampling, make_sun

MAX_DIST = 1024.0
F_SUB_SURFACE_DEFAULT = 0.3


class EmitterSampling:
    """Emitter sampling strategies."""

    NONE = "none"
    ONE = "one"
    ONE_BLOCK = "one_block"
    ALL = "all"


@dataclasses.dataclass
class Scene:
    nodes: torch.Tensor  # (N, 8) int32 packed node table
    root: int
    depth: int
    materials: MaterialTable
    atlas: Any  # (T, H, W, 4) linear float32 tensor, or an Atlas
    sun: Sun
    leaf_material: torch.Tensor  # (L,) int32: leaf value -> material id
    # block models (non-cube leaf geometry, models/blockmodels.py), or None
    models: Any = None
    # analytic primitives (free spheres and quads, models/prims.py), or None
    prims: Any = None
    # emissive-leaf table for emitter sampling (models/emitters.py), or None
    emitters: Any = None
    sun_sampling: SunSampling = dataclasses.field(default_factory=SunSampling.importance)
    emitter_sampling: str = EmitterSampling.NONE
    emitters_enabled: bool = True
    f_sub_surface: float = F_SUB_SURFACE_DEFAULT
    # True when no leaf can be rejected by an alpha or quad test: the
    # traversal then runs without the in-loop accept (K1 instead of K2)
    opaque_only: bool = False
    # True when some block model is made of quads
    has_quad_models: bool = False
    # True when every reachable texel alpha is exactly 1 and no model is made
    # of quads: a shadow walk stops at its first surface
    shadow_binary: bool = False

    @property
    def octree_scale(self) -> float:
        """World voxel units -> the traversal's [1, 2) cube."""
        return float(2.0 ** (-self.depth))

    @property
    def n_nodes(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def to(self, device) -> "Scene":
        return dataclasses.replace(
            self,
            nodes=self.nodes.to(device),
            materials=self.materials.to(device),
            atlas=self.atlas.to(device),
            sun=self.sun.to(device),
            leaf_material=self.leaf_material.to(device),
            models=None if self.models is None else self.models.to(device),
            prims=None if self.prims is None else self.prims.to(device),
            emitters=None if self.emitters is None else self.emitters.to(device),
        )


_FACE_NORMALS = np.array(
    [
        [-1, 0, 0],  # 0: entered the -x face (ray going +x)
        [1, 0, 0],  # 1: entered the +x face (ray going -x)
        [0, -1, 0],
        [0, 1, 0],
        [0, 0, -1],
        [0, 0, 1],
    ],
    np.float32,
)


def face_normals(device=None):
    """face_id (axis*2 | negative-dir bit) -> outward normal of the entered face."""
    return torch.as_tensor(_FACE_NORMALS, device=device)


def _alpha_flags(atlas, texture_index, has_quad_models: bool):
    """(opaque_only, shadow_binary) from the atlas's per-layer min alpha over
    the layers the materials reference; quad models are part of neither."""
    data = atlas.data if isinstance(atlas, Atlas) else atlas
    data = np.asarray(data.cpu() if isinstance(data, torch.Tensor) else data)
    min_alpha = data[..., 3].reshape(data.shape[0], -1).min(axis=1)
    tex_idx = np.asarray(texture_index)
    m_min_alpha = min_alpha[np.clip(tex_idx, 0, len(min_alpha) - 1)]
    no_quads = not has_quad_models
    return bool(np.all(m_min_alpha > 5e-8)) and no_quads, bool(np.all(m_min_alpha >= 1.0 - 1e-7)) and no_quads


def make_scene(
    octree,
    materials: MaterialTable,
    atlas,
    sun: Sun | None = None,
    leaf_material=None,
    models=None,
    prims=None,
    brick: bool = False,
    **kwargs,
) -> Scene:
    """Build a scene from a numpy ``Octree`` (``octree/``), with optional
    block ``models`` (``BlockModels``) and analytic ``prims``
    (``Primitives``).  ``has_quad_models``, ``opaque_only`` and
    ``shadow_binary`` are derived unless given.  With an ``emitter_sampling``
    other than NONE and no ``emitters`` given, the emissive-leaf table is
    built from the octree.

    The brick layout is not ported and raises ``NotImplementedError``."""
    if brick or hasattr(octree, "bricks"):  # a BrickOctree
        raise NotImplementedError("the brick layout is not ported (ROADMAP queue 1, 'Not to port')")
    if sun is None:
        sun = make_sun()
    if leaf_material is None:
        # leaves hold material ids directly; identity map sized by table
        leaf_material = torch.arange(materials.count, dtype=torch.int32)
    if models is not None and "has_quad_models" not in kwargs:
        kwargs["has_quad_models"] = bool(((models.flags & FLAG_SIMPLE) == 0).any())
    if "opaque_only" not in kwargs or "shadow_binary" not in kwargs:
        opaque_only, shadow_binary = _alpha_flags(atlas, materials.texture_index,
                                                  kwargs.get("has_quad_models", False))
        kwargs.setdefault("opaque_only", opaque_only)
        kwargs.setdefault("shadow_binary", shadow_binary)
    leaf_material = torch.as_tensor(leaf_material, dtype=torch.int32)
    if kwargs.get("emitter_sampling", EmitterSampling.NONE) != EmitterSampling.NONE and "emitters" not in kwargs:
        from .emitters import build_emitter_table

        kwargs["emitters"] = build_emitter_table(octree, leaf_material, materials, models)
    nodes = pack_nodes(
        torch.from_numpy(np.asarray(octree.child_mask).astype(np.int64)),
        torch.from_numpy(np.asarray(octree.child_data).astype(np.int64)),
    )
    return Scene(
        nodes=nodes,
        root=int(octree.root),
        depth=int(octree.depth),
        materials=materials,
        atlas=atlas,
        sun=sun,
        leaf_material=leaf_material,
        models=models,
        prims=prims,
        **kwargs,
    )
