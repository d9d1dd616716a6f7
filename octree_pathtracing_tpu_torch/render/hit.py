"""Hit resolution: traversal results -> (material, uv, normal, t), and the
tables of the in-loop alpha accept — port of ``render/hit.py`` for scenes
without block models (every leaf is a full cube whose leaf value maps to a
material through ``scene.leaf_material``)."""

from __future__ import annotations

import torch

from ..models.scene import Scene, face_normals
from ..ops.shading import EPSILON
from ..ops.texture import Atlas
from ..ops.traversal import AlphaTables


def _leaf_mat(scene: Scene, leaf_value):
    n = scene.leaf_material.shape[0]
    return scene.leaf_material[torch.clamp(leaf_value.long(), 0, n - 1)]


def resolve_hit(scene: Scene, origins, dirs, res):
    """Final hit attributes: (mat (B,), uv (B, 2), normal (B, 3), t (B,))."""
    normals = face_normals(res.face_id.device)
    base_normal = normals[torch.clamp(res.face_id.long(), 0, 5)]
    return _leaf_mat(scene, res.leaf_value), res.uv, base_normal, res.t


def _leaf_min_alpha(scene: Scene):
    """(L,) smallest texel alpha of each leaf's material, from the live atlas
    (trained alphas move it)."""
    data = scene.atlas.data if isinstance(scene.atlas, Atlas) else scene.atlas
    layer_min = data[..., 3].reshape(data.shape[0], -1).amin(dim=1)  # (T,)
    tex = scene.materials.texture_index.long()
    m_min = layer_min[torch.clamp(tex, 0, layer_min.shape[0] - 1)]  # (M,)
    return m_min[scene.leaf_material.long()]


def leaf_alpha_classes(scene: Scene):
    """(L,) bool: leaves some texel of whose material has alpha <= EPSILON,
    so that the accept test could reject them (``_leaf_alpha_classes``'
    first table)."""
    return _leaf_min_alpha(scene) <= EPSILON


def accept_tables(scene: Scene) -> AlphaTables:
    """The detached tables the accepting traversals read, with the shadow
    walk's binary class (``_leaf_alpha_classes``' second table: every texel
    alpha exactly 1) and the material IOR."""
    with torch.no_grad():
        atlas = scene.atlas
        data = atlas.data if isinstance(atlas, Atlas) else atlas
        min_alpha = _leaf_min_alpha(scene)
        return AlphaTables(
            leaf_material=scene.leaf_material.contiguous(),
            texture_index=scene.materials.texture_index.contiguous(),
            atlas=data.detach().contiguous(),
            sizes=atlas.sizes.contiguous() if isinstance(atlas, Atlas) else None,
            rejectable=(min_alpha <= EPSILON).contiguous(),
            binary=(min_alpha >= 1.0).contiguous(),
            ior=scene.materials.ior.detach().contiguous(),
        )
