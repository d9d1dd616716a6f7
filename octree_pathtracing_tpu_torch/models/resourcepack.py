"""Minecraft resource-pack assets: blockstate and model JSONs -> quads
(copy of ``octree_pathtracing_tpu/models/resourcepack.py``).

- blockstate JSON resolution: variants (with property-key matching) and
  multipart -> model reference + x/y rotation;
- block-model parent-chain resolution with ``#texture_variable``
  indirection;
- elements (from/to boxes, per-face uv + texture) -> quads in block-local
  [0, 1]^3 coordinates;
- element rotations about a pivot, variant quarter turns and uvlock.

The quads feed :class:`~.blockmodels.ModelBuilder` and the texture atlas
(``blockpalette.compile_world_assets``); the color table of
``blockpalette.py`` stays the no-assets fallback.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

# face name -> (origin, u, v) in block-local units (model units / 16)
_FACE_BASIS = {
    "down": (lambda f, t: ([f[0], f[1], f[2]], [t[0] - f[0], 0, 0], [0, 0, t[2] - f[2]])),
    "up": (lambda f, t: ([t[0], t[1], f[2]], [f[0] - t[0], 0, 0], [0, 0, t[2] - f[2]])),
    "north": (lambda f, t: ([t[0], f[1], f[2]], [f[0] - t[0], 0, 0], [0, t[1] - f[1], 0])),
    "south": (lambda f, t: ([f[0], f[1], t[2]], [t[0] - f[0], 0, 0], [0, t[1] - f[1], 0])),
    "west": (lambda f, t: ([f[0], f[1], f[2]], [0, 0, t[2] - f[2]], [0, t[1] - f[1], 0])),
    "east": (lambda f, t: ([t[0], f[1], t[2]], [0, 0, f[2] - t[2]], [0, t[1] - f[1], 0])),
}

_FACE_TO_ID = {"west": 0, "east": 1, "down": 2, "up": 3, "north": 4, "south": 5}


class ResourcePack:
    """Reads model/blockstate/texture JSONs from a pack directory tree."""

    def __init__(self, root: str):
        self.root = root
        self._model_cache: dict[str, dict] = {}

    def _path(self, kind: str, name: str, ext: str) -> str:
        ns, _, rest = name.partition(":")
        if not rest:
            ns, rest = "minecraft", ns
        return os.path.join(self.root, "assets", ns, kind, rest + ext)

    def load_json(self, kind: str, name: str) -> Optional[dict]:
        p = self._path(kind, name, ".json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def texture_path(self, name: str) -> Optional[str]:
        p = self._path("textures", name, ".png")
        return p if os.path.exists(p) else None

    # ---- model resolution (parent chain + texture variables) ----

    def resolve_model(self, name: str) -> dict:
        """Flatten the parent chain: merged elements + texture variable map."""
        if name in self._model_cache:
            return self._model_cache[name]
        chain = []
        cur = name
        for _ in range(16):  # parent chains are short; guard cycles
            m = self.load_json("models", cur)
            if m is None:
                break
            chain.append(m)
            cur = m.get("parent", "")
            if not cur or cur.startswith("builtin/"):
                break
        textures: dict[str, str] = {}
        elements = None
        for m in reversed(chain):  # parents first, children override
            textures.update(m.get("textures", {}))
            if "elements" in m:
                elements = m["elements"]
        resolved = {"textures": textures, "elements": elements or []}
        self._model_cache[name] = resolved
        return resolved

    def resolve_texture_var(self, textures: dict, ref: str, depth: int = 8) -> Optional[str]:
        """Follow '#var' indirection chains."""
        while ref.startswith("#") and depth > 0:
            ref = textures.get(ref[1:], "")
            depth -= 1
        return ref or None


def _rotate_point_y(p, quarters):
    x, y, z = p
    for _ in range(quarters % 4):
        x, z = z, 1.0 - x
    return [x, y, z]


def _rotate_vec_y(v, quarters):
    x, y, z = v
    for _ in range(quarters % 4):
        x, z = z, -x
    return [x, y, z]


def _rotate_point_x(p, quarters):
    x, y, z = p
    for _ in range(quarters % 4):
        y, z = 1.0 - z, y
    return [x, y, z]


def _rotate_vec_x(v, quarters):
    x, y, z = v
    for _ in range(quarters % 4):
        y, z = -z, y
    return [x, y, z]


_AXIS_INDEX = {"x": 0, "y": 1, "z": 2}


def _axis_rotation_matrix(axis: str, degrees: float) -> np.ndarray:
    a = np.deg2rad(degrees)
    c, s = np.cos(a), np.sin(a)
    i = _AXIS_INDEX[axis]
    j, k = (i + 1) % 3, (i + 2) % 3
    m = np.zeros((3, 3))
    m[i, i] = 1.0
    m[j, j] = c
    m[k, k] = c
    m[j, k] = -s
    m[k, j] = s
    return m


def _apply_element_rotation(o, u, v, rot: dict):
    """Element rotation about a pivot: rotate (origin, u, v) about
    ``rot.origin/16`` by ``rot.angle`` degrees around ``rot.axis``; MC's
    ``rescale`` stretches the two non-axis dimensions by 1/cos(angle) so
    ±45° diagonals still span the block."""
    pivot = np.asarray(rot.get("origin", [8.0, 8.0, 8.0]), float) / 16.0
    axis = rot.get("axis", "y")
    angle = float(rot.get("angle", 0.0))
    m = _axis_rotation_matrix(axis, angle)
    if rot.get("rescale", False) and abs(angle) > 1e-9:
        s = 1.0 / np.cos(np.deg2rad(abs(angle)))
        scale = np.full(3, s)
        scale[_AXIS_INDEX[axis]] = 1.0
        m = np.diag(scale) @ m
    o = list(m @ (np.asarray(o, float) - pivot) + pivot)
    u = list(m @ np.asarray(u, float))
    v = list(m @ np.asarray(v, float))
    return o, u, v


def _param_rotate_quad(o, u, v, quarters: int):
    """Rotate a quad's (origin, u, v) *parameterization* in-plane by 90-degree
    steps without moving its geometry or normal: the texture appears rotated
    by -90*quarters about the face normal.  (o+U re-anchor keeps u x v — and
    hence the quad normal and plane — unchanged.)"""
    o, u, v = np.asarray(o, float), np.asarray(u, float), np.asarray(v, float)
    for _ in range(quarters % 4):
        o, u, v = o + u, v, -u
    return list(o), list(u), list(v)


# quarter-turn face-name cycle about the x axis (normal map: north->up->
# south->down->north)
_X_CYCLE = ["north", "up", "south", "down"]


def _face_rotate_x(name: str, quarters: int) -> str:
    if name not in _X_CYCLE:
        return name
    return _X_CYCLE[(_X_CYCLE.index(name) + quarters) % 4]


def _uvlock_rotation(face_name: str, qx: int, qy: int) -> int:
    """uvlock counter-rotation quarters for a face: up faces counter the
    y-rotation, down faces co-rotate, side faces counter y only when the
    x-rotation moves them to the up/down plane.  Returns texture-rotation
    quarters (CCW about the normal)."""
    y_deg = (qy * 90) % 360
    if face_name == "up":
        rot = -y_deg
    elif face_name == "down":
        rot = y_deg
    else:
        if qx % 4 == 0:
            rot = -y_deg
        else:
            moved = _face_rotate_x(face_name, qx)
            rot = -y_deg if moved == "up" else (y_deg if moved == "down" else 0)
    return ((rot % 360) // 90) % 4


def model_to_quads(
    pack: ResourcePack,
    model_name: str,
    material_of_texture,
    rot_x: int = 0,
    rot_y: int = 0,
    uvlock: bool = False,
) -> list[dict]:
    """Resolve one model into quad dicts for ModelBuilder.add_quad_model.

    ``material_of_texture(texture_name, tint_index) -> material id`` performs
    the global texture/material dedup; ``tint_index`` is the face's
    biome-tint slot (-1 = untinted).  Variant rotations are quarter-turn
    point/vector rotations about the block center; element rotations are
    arbitrary-angle pivot rotations; ``uvlock`` applies the per-face texture
    counter-rotation.
    """
    resolved = pack.resolve_model(model_name)
    quads = []
    qx = (int(rot_x) // 90) % 4
    qy = (int(rot_y) // 90) % 4
    for el in resolved["elements"]:
        f = [c / 16.0 for c in el.get("from", [0, 0, 0])]
        t = [c / 16.0 for c in el.get("to", [16, 16, 16])]
        el_rot = el.get("rotation")
        for face_name, face in el.get("faces", {}).items():
            if face_name not in _FACE_BASIS:
                continue
            o, u, v = _FACE_BASIS[face_name](f, t)
            tex_ref = face.get("texture", "")
            tex = pack.resolve_texture_var(resolved["textures"], tex_ref)
            if tex is None:
                continue
            tint = int(face.get("tintindex", -1))
            try:
                mat = material_of_texture(tex, tint)
            except TypeError:  # tint-unaware callback
                mat = material_of_texture(tex)
            uv = face.get("uv")
            if uv:
                ur = (uv[0] / 16.0, uv[2] / 16.0)
                vr = (uv[1] / 16.0, uv[3] / 16.0)
            else:
                ur, vr = (0.0, 1.0), (0.0, 1.0)
            if el_rot:
                o, u, v = _apply_element_rotation(o, u, v, el_rot)
            # variant rotations: x then y
            if qx:
                o = _rotate_point_x(o, qx)
                u = _rotate_vec_x(u, qx)
                v = _rotate_vec_x(v, qx)
            if qy:
                o = _rotate_point_y(o, qy)
                u = _rotate_vec_y(u, qy)
                v = _rotate_vec_y(v, qy)
            if uvlock and (qx or qy):
                rq = _uvlock_rotation(face_name, qx, qy)
                if rq:
                    o, u, v = _param_rotate_quad(o, u, v, rq)
            quads.append(
                dict(origin=o, u=u, v=v, material=mat, uv_range=(ur, vr), tint=tint)
            )
    return quads


def _when_matches(when: dict, properties: dict) -> bool:
    """Multipart ``when`` condition: key=value pairs (|-alternatives) AND'd;
    ``OR``/``AND`` combinators hold lists of sub-conditions."""
    if "OR" in when:
        return any(_when_matches(w, properties) for w in when["OR"])
    if "AND" in when:
        return all(_when_matches(w, properties) for w in when["AND"])
    return all(
        str(properties.get(k)) in str(v).split("|") for k, v in when.items()
    )


def pick_variants(blockstate_json: dict, properties: dict) -> list[dict]:
    """All variant entries to apply for a property set: exactly one for
    ``variants`` blockstates, and EVERY matching part for ``multipart``
    (parts are additive — fences, walls)."""
    variants = blockstate_json.get("variants")
    if variants is not None:
        prop_str = ",".join(f"{k}={v}" for k, v in sorted(properties.items()))
        for key in (prop_str, ""):
            if key in variants:
                v = variants[key]
                return [v[0] if isinstance(v, list) else v]
        # partial matches: every key=val in the variant key must hold
        for key, v in variants.items():
            if not key:
                continue
            pairs = dict(kv.split("=") for kv in key.split(","))
            if all(properties.get(k) == val for k, val in pairs.items()):
                return [v[0] if isinstance(v, list) else v]
        return []
    out = []
    for part in blockstate_json.get("multipart", []):
        when = part.get("when")
        if when is None or _when_matches(when, properties):
            apply = part.get("apply")
            out.append(apply[0] if isinstance(apply, list) else apply)
    return out


def pick_variant(blockstate_json: dict, properties: dict) -> Optional[dict]:
    """First applicable variant (compat shim over :func:`pick_variants`)."""
    vs = pick_variants(blockstate_json, properties)
    return vs[0] if vs else None


def compile_blockstate(
    pack: ResourcePack, blockstate_key: str, material_of_texture
) -> Optional[list[dict]]:
    """Blockstate string ('ns:name#k=v,...') -> quad list (all multipart
    contributions merged), or None if the pack lacks assets for it."""
    base, _, props_str = blockstate_key.partition("#")
    props = dict(kv.split("=") for kv in props_str.split(",")) if props_str else {}
    bs = pack.load_json("blockstates", base)
    if bs is None:
        return None
    variants = pick_variants(bs, props)
    if not variants:
        return None
    quads: list[dict] = []
    for variant in variants:
        model = variant.get("model", "")
        if model.startswith("minecraft:"):
            model = model.split(":", 1)[1]
        quads.extend(
            model_to_quads(
                pack,
                model,
                material_of_texture,
                rot_x=int(variant.get("x", 0)),
                rot_y=int(variant.get("y", 0)),
                uvlock=bool(variant.get("uvlock", False)),
            )
        )
    return quads or None
