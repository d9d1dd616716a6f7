"""Hit resolution: traversal results -> (material, uv, normal, t), and the
tables of the in-loop accept (port of ``render/hit.py``).  ``resolve_hit``
itself is part of kernel K4's twin and lives in ``ops/shade.py``; it
resolves

- no model table: leaf value -> material through ``scene.leaf_material``,
  the entry face's uv and normal (every leaf a full cube);
- simple block models: the model's per-face material;
- quad models: the nearest accepted quad, which the accepting traversal
  found and returned (``HitResult.quad``, written by kernel K2q on the card
  and by its twin on the CPU); the scan is not run again here.

The accept itself and its quad scan run inside the traversal
(``ops/traversal._surface_of_candidate`` and ``_quad_scan``, the twins of
the JAX ``_surface_of_candidate`` and ``_quad_scan``); this module builds
the tables they read.
"""

from __future__ import annotations

import torch

from ..models.blockmodels import FLAG_SIMPLE
from ..models.scene import Scene
from ..ops.shade import resolve_hit  # noqa: F401 (this module's name since the port began)
from ..ops.shading import EPSILON
from ..ops.texture import Atlas
from ..ops.traversal import AlphaTables


def _leaf_alpha_classes(scene: Scene):
    """(rejectable, binary), (L,) bool per leaf value, from the live atlas
    (trained alphas move them).

    ``rejectable``: some texel of the leaf's material(s) has alpha <=
    EPSILON, or the leaf is a quad model, so that the accept could reject
    it.  ``binary``: every texel alpha is exactly 1 and the leaf is a full
    cube (a simple model, or any leaf without models): a total blocker for
    the shadow walk, read without a texel fetch."""
    data = scene.atlas.data if isinstance(scene.atlas, Atlas) else scene.atlas
    layer_min = data[..., 3].reshape(data.shape[0], -1).amin(dim=1)  # (T,)
    tex = scene.materials.texture_index.long()
    m_min = layer_min[torch.clamp(tex, 0, layer_min.shape[0] - 1)]  # (M,)
    if scene.models is None:
        lm_min = m_min[scene.leaf_material.long()]  # (L,)
        return lm_min <= EPSILON, lm_min >= 1.0
    m = scene.models
    model_min = m_min[m.face_material.long()].amin(dim=1)  # (Mm,)
    simple = (m.flags & FLAG_SIMPLE) != 0  # (Mm,)
    lv_min = model_min[m.leaf_model.long()]  # (L,)
    lv_simple = simple[m.leaf_model.long()]
    return (lv_min <= EPSILON) | ~lv_simple, (lv_min >= 1.0) & lv_simple


def leaf_alpha_classes(scene: Scene):
    """(L,) bool: the leaves the accept test could reject
    (``_leaf_alpha_classes``' first table)."""
    return _leaf_alpha_classes(scene)[0]


def accept_tables(scene: Scene) -> AlphaTables:
    """The detached tables the accepting traversals read: the class tables,
    the material IOR and, on a scene with block models, the model tables."""
    with torch.no_grad():
        atlas = scene.atlas
        data = atlas.data if isinstance(atlas, Atlas) else atlas
        rejectable, binary = _leaf_alpha_classes(scene)
        tables = AlphaTables(
            leaf_material=scene.leaf_material.contiguous(),
            texture_index=scene.materials.texture_index.contiguous(),
            atlas=data.detach().contiguous(),
            sizes=atlas.sizes.contiguous() if isinstance(atlas, Atlas) else None,
            rejectable=rejectable.contiguous(),
            binary=binary.contiguous(),
            ior=scene.materials.ior.detach().contiguous(),
        )
        m = scene.models
        if m is None:
            return tables
        return tables._replace(leaf_model=m.leaf_model, flags=m.flags, face_material=m.face_material,
                               quad_start=m.quad_start, quad_count=m.quad_count, quads=m.quads)
