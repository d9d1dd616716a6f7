"""Scenes carried over from the JAX package as numpy arrays.

:func:`scene_from_numpy` builds this port's :class:`Scene` from plain
arrays; :func:`scene_from_jax_arrays` reads them off a scene of
``octree_pathtracing_tpu`` (any object with its attribute layout — no jax
import is needed, ``np.asarray`` does the transfer).  The tests use both to
feed the two packages the same scene.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.texture import Atlas
from ..ops.traversal import pack_nodes
from .emitters import EmitterTable
from .materials import MaterialTable
from .scene import Scene
from .sun import Sun, SunSampling

_SUN_FIELDS = [f.name for f in dataclasses.fields(Sun) if f.name != "draw_texture"]
_MATERIAL_INT_FIELDS = ("flags", "texture_index", "tint_index")
_EMITTER_ARRAYS = {"pos": np.float32, "size": np.float32, "mat": np.int32,
                   "grid_idx": np.int32, "grid_w": np.float32}
_EMITTER_STATICS = ("grid_bits", "cell_size", "lam")


def _t(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(dtype)))


def scene_from_numpy(
    child_mask,
    child_data,
    root: int,
    depth: int,
    materials: dict,
    atlas,
    atlas_sizes,
    sun: dict,
    leaf_material,
    sun_sampling: SunSampling | None = None,
    emitter_sampling: str = "none",
    emitters_enabled: bool = True,
    f_sub_surface: float = 0.3,
    opaque_only: bool = False,
    shadow_binary: bool = False,
    emitters: dict | None = None,
) -> Scene:
    """Scene from numpy leaves.

    ``materials``: column name -> (M,) array (the MaterialTable fields);
    ``atlas``: (T, H, W, 4) float32 with ``atlas_sizes`` (T, 2) for a
    variable-resolution atlas, or ``atlas_sizes=None``; ``sun``: field name
    -> array for every tensor field of :class:`Sun`, plus ``draw_texture``;
    ``emitters``: None or field name -> value for every field of
    :class:`EmitterTable` (``grid_idx`` / ``grid_w`` may be None)."""
    table = MaterialTable(
        **{
            k: _t(materials[k], np.int32 if k in _MATERIAL_INT_FIELDS else np.float32)
            for k in (f.name for f in dataclasses.fields(MaterialTable))
        }
    )
    atlas_t = _t(atlas, np.float32)
    if atlas_sizes is not None:
        atlas_t = Atlas(atlas_t, _t(atlas_sizes, np.int32))
    sun_t = Sun(
        **{k: _t(sun[k], np.float32) for k in _SUN_FIELDS},
        draw_texture=bool(sun.get("draw_texture", True)),
    )
    nodes = pack_nodes(_t(child_mask, np.int64), _t(child_data, np.int64))
    em_table = None
    if emitters is not None:
        em_table = EmitterTable(
            **{k: None if emitters[k] is None else _t(emitters[k], dt) for k, dt in _EMITTER_ARRAYS.items()},
            grid_bits=int(emitters["grid_bits"]),
            cell_size=float(emitters["cell_size"]),
            lam=float(emitters["lam"]),
        )
    return Scene(
        nodes=nodes,
        root=int(root),
        depth=int(depth),
        materials=table,
        atlas=atlas_t,
        sun=sun_t,
        leaf_material=_t(leaf_material, np.int32),
        emitters=em_table,
        sun_sampling=dataclasses.replace(sun_sampling) if sun_sampling else SunSampling.importance(),
        emitter_sampling=emitter_sampling,
        emitters_enabled=bool(emitters_enabled),
        f_sub_surface=float(f_sub_surface),
        opaque_only=bool(opaque_only),
        shadow_binary=bool(shadow_binary),
    )


def scene_from_jax_arrays(jscene) -> Scene:
    """Port scene from a JAX-package ``Scene`` (plain octree, no block
    models or primitives), its emitter table included."""
    if jscene.models is not None or jscene.prims is not None:
        raise NotImplementedError("block models / primitives: ROADMAP queue 1, item 7")
    if hasattr(jscene.octree, "bricks"):
        raise NotImplementedError("the brick layout is not ported (ROADMAP queue 1, 'Not to port')")
    tree = jscene.octree
    m = jscene.materials
    atlas = jscene.atlas
    sizes = getattr(atlas, "sizes", None)
    em = jscene.emitters
    emitters = None
    if em is not None:
        emitters = {k: None if getattr(em, k) is None else np.asarray(getattr(em, k)) for k in _EMITTER_ARRAYS}
        emitters.update({k: getattr(em, k) for k in _EMITTER_STATICS})
    return scene_from_numpy(
        child_mask=np.asarray(tree.child_mask),
        child_data=np.asarray(tree.child_data),
        root=tree.root,
        depth=tree.depth,
        materials={f.name: np.asarray(getattr(m, f.name)) for f in dataclasses.fields(MaterialTable)},
        atlas=np.asarray(atlas.data if sizes is not None else atlas),
        atlas_sizes=None if sizes is None else np.asarray(sizes),
        sun={**{k: np.asarray(getattr(jscene.sun, k)) for k in _SUN_FIELDS},
             "draw_texture": jscene.sun.draw_texture},
        leaf_material=np.asarray(jscene.leaf_material),
        sun_sampling=SunSampling(**dataclasses.asdict(jscene.sun_sampling)),
        emitter_sampling=jscene.emitter_sampling,
        emitters_enabled=jscene.emitters_enabled,
        f_sub_surface=jscene.f_sub_surface,
        opaque_only=jscene.opaque_only,
        shadow_binary=jscene.shadow_binary,
        emitters=emitters,
    )
