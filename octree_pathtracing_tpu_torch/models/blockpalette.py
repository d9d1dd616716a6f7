"""Blockstate -> renderable material compiler (copy of
``octree_pathtracing_tpu/models/blockpalette.py``).

Without a resource pack (:func:`compile_block_palette`) every blockstate
becomes a full cube with one material and a 16x16 texture: a built-in
table of vanilla colors (emissive, translucent and refractive blocks
included) with per-texel noise, and a hash color for unknown blocks.  With
a pack (:func:`compile_world_assets`) blockstates resolve to the pack's
geometry and textures (``resourcepack.py``) and become simple cubes with
per-face materials or quad models; blocks the pack lacks fall back to the
color table.  :func:`minecraft_scene_from_region` builds the scene and a
default camera from a region file or a world directory.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..ops.texture import build_atlas
from .materials import FLAG_OPAQUE, FLAG_REFRACTIVE, FLAG_SOLID, air, make_material_table

# name -> (rgb, dict of material overrides)
VANILLA_COLORS = {
    "minecraft:stone": ((125, 125, 125), {}),
    "minecraft:cobblestone": ((110, 110, 110), {}),
    "minecraft:granite": ((154, 108, 90), {}),
    "minecraft:diorite": ((188, 188, 190), {}),
    "minecraft:andesite": ((132, 135, 132), {}),
    "minecraft:deepslate": ((80, 80, 85), {}),
    "minecraft:bedrock": ((60, 60, 60), {}),
    "minecraft:dirt": ((134, 96, 67), {}),
    "minecraft:grass_block": ((95, 159, 53), {}),
    "minecraft:sand": ((219, 207, 163), {}),
    "minecraft:gravel": ((136, 126, 126), {}),
    "minecraft:oak_log": ((109, 85, 50), {}),
    "minecraft:oak_planks": ((162, 130, 78), {}),
    "minecraft:oak_leaves": ((60, 143, 40), {"alpha": 0.8}),
    "minecraft:spruce_log": ((58, 37, 16), {}),
    "minecraft:spruce_leaves": ((44, 96, 44), {"alpha": 0.8}),
    "minecraft:birch_log": ((216, 215, 210), {}),
    "minecraft:water": ((48, 90, 220), {"alpha": 0.35, "ior": 1.33, "refractive": True}),
    "minecraft:lava": ((230, 110, 20), {"emittance": 4.0}),
    "minecraft:glowstone": ((255, 220, 120), {"emittance": 6.0}),
    "minecraft:sea_lantern": ((210, 235, 230), {"emittance": 5.0}),
    "minecraft:torch": ((255, 200, 100), {"emittance": 5.0}),
    "minecraft:glass": ((235, 245, 250), {"alpha": 0.1, "ior": 1.52, "refractive": True}),
    "minecraft:ice": ((160, 190, 255), {"alpha": 0.6, "ior": 1.31, "refractive": True}),
    "minecraft:snow": ((250, 250, 250), {}),
    "minecraft:snow_block": ((245, 245, 245), {}),
    "minecraft:iron_block": ((220, 220, 220), {"metalness": 0.9, "roughness": 0.15}),
    "minecraft:gold_block": ((250, 215, 60), {"metalness": 0.9, "roughness": 0.1}),
    "minecraft:diamond_block": ((110, 230, 220), {"specular": 0.4, "roughness": 0.05}),
    "minecraft:obsidian": ((20, 16, 30), {"specular": 0.2, "roughness": 0.05}),
    "minecraft:netherrack": ((110, 55, 55), {}),
    "minecraft:coal_ore": ((105, 105, 105), {}),
    "minecraft:iron_ore": ((135, 125, 115), {}),
}


def _hash_color(name: str):
    h = hashlib.sha1(name.encode()).digest()
    return (96 + h[0] % 128, 96 + h[1] % 128, 96 + h[2] % 128)


def compile_block_palette(blockstate_map: dict[str, int]):
    """Build (materials, atlas, leaf_material) from a blockstate-id map.

    leaf values in the octree are global blockstate ids; ``leaf_material``
    maps them to material ids (one hop for cube blocks).
    """
    n_states = max(blockstate_map.values()) + 1 if blockstate_map else 1
    leaf_material = np.zeros(n_states, np.int32)

    materials = [air()]
    textures = [np.full((16, 16, 4), (255, 0, 255, 255), np.uint8)]  # default magenta

    for name, state_id in sorted(blockstate_map.items(), key=lambda kv: kv[1]):
        if state_id == 0:
            continue
        base = name.split("#", 1)[0]
        rgb, props = VANILLA_COLORS.get(base, (_hash_color(base), {}))
        alpha = props.get("alpha", 1.0)
        tex = np.zeros((16, 16, 4), np.uint8)
        # subtle per-texel noise so blocks read as textured, not flat
        rng = np.random.default_rng(abs(hash(base)) % (2**32))
        noise = rng.integers(-12, 12, (16, 16, 1))
        tex[..., :3] = np.clip(np.asarray(rgb)[None, None] + noise, 0, 255)
        tex[..., 3] = int(alpha * 255)
        textures.append(tex)
        mat = dict(
            texture_index=len(textures) - 1,
            emittance=props.get("emittance", 0.0),
            specular=props.get("specular", 0.0),
            roughness=props.get("roughness", 0.0),
            metalness=props.get("metalness", 0.0),
            ior=props.get("ior", 1.000293),
            flags=(FLAG_OPAQUE | FLAG_SOLID)
            | (FLAG_REFRACTIVE if props.get("refractive") else 0),
        )
        materials.append(mat)
        leaf_material[state_id] = len(materials) - 1

    return make_material_table(materials), build_atlas(textures), leaf_material


# biome tint applied to tinted faces when no biome data is available
# (plains grass/foliage color: without per-column biomes one constant is baked)
_DEFAULT_TINT = (145, 189, 89)

# faces of a unit cube, used to recognize full-cube quad models -> FLAG_SIMPLE
_FACE_NORMAL_TO_ID = {
    (-1, 0, 0): 0,  # west
    (1, 0, 0): 1,  # east
    (0, -1, 0): 2,  # down
    (0, 1, 0): 3,  # up
    (0, 0, -1): 4,  # north
    (0, 0, 1): 5,  # south
}


def _cube_face_id(q: dict):
    """Face id if the quad is exactly a unit-cube face, else None."""
    o = np.asarray(q["origin"], float)
    u = np.asarray(q["u"], float)
    v = np.asarray(q["v"], float)
    corners = np.stack([o, o + u, o + v, o + u + v])
    if not np.allclose(np.abs(corners - 0.5), 0.5, atol=1e-6):
        return None
    n = np.cross(u, v)
    ln = np.linalg.norm(n)
    if not np.isclose(ln, 1.0, atol=1e-6):  # full-face area
        return None
    key = tuple(int(round(c)) for c in n / ln)
    return _FACE_NORMAL_TO_ID.get(key)


class _PackMaterials:
    """Global texture/material dedup:
    one atlas layer per (texture, tint) pair, one material per layer +
    property set."""

    def __init__(self, pack):
        self.pack = pack
        self.textures = [np.full((16, 16, 4), (255, 0, 255, 255), np.uint8)]
        self.materials = [air()]
        self._by_key: dict = {}

    def _load_texture(self, name: str):
        from ..io.image import load_image

        p = self.pack.texture_path(name)
        if p is None:
            return None
        img = load_image(p)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        if img.ndim == 2:
            img = np.stack([img] * 3 + [np.full_like(img, 255)], -1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
        # animated textures are vertical frame strips; keep frame 0
        if img.shape[0] > img.shape[1]:
            img = img[: img.shape[1]]
        return img

    def material_of_texture(self, tex_name: str, tint: int = -1,
                            props: dict | None = None, tint_rgb=None):
        """-> material id (creating texture layer + material on first use).

        ``tint_rgb``: resolved biome tint color for tinted faces
        (``models/biomes.py``); None falls back to the plains constant."""
        # key on the actual tint index AND resolved color: two textures with
        # different tint indices or biome colors must not alias to one
        # material/atlas layer (ADVICE r3 — load-bearing for per-biome tints)
        key = (tex_name, tint, tuple(tint_rgb) if tint_rgb else None,
               tuple(sorted((props or {}).items())))
        if key in self._by_key:
            return self._by_key[key]
        img = self._load_texture(tex_name)
        if img is None:
            rgb = _hash_color(tex_name)
            img = np.zeros((16, 16, 4), np.uint8)
            img[..., :3] = rgb
            img[..., 3] = 255
        if tint >= 0:
            t = np.asarray(tint_rgb or _DEFAULT_TINT, np.float32) / 255.0
            img = img.copy()
            img[..., :3] = np.clip(img[..., :3] * t[None, None], 0, 255).astype(np.uint8)
        self.textures.append(img)
        props = props or {}
        mat = dict(
            texture_index=len(self.textures) - 1,
            emittance=props.get("emittance", 0.0),
            specular=props.get("specular", 0.0),
            roughness=props.get("roughness", 0.0),
            metalness=props.get("metalness", 0.0),
            ior=props.get("ior", 1.000293),
            tint_index=tint,
            flags=(FLAG_OPAQUE | FLAG_SOLID)
            | (FLAG_REFRACTIVE if props.get("refractive") else 0),
        )
        self.materials.append(mat)
        self._by_key[key] = len(self.materials) - 1
        return self._by_key[key]

    def palette_material(self, block_name: str):
        """No-assets fallback: the phase-1 color material for this block."""
        key = ("palette", block_name)
        if key in self._by_key:
            return self._by_key[key]
        rgb, props = VANILLA_COLORS.get(block_name, (_hash_color(block_name), {}))
        alpha = props.get("alpha", 1.0)
        tex = np.zeros((16, 16, 4), np.uint8)
        rng = np.random.default_rng(abs(hash(block_name)) % (2**32))
        noise = rng.integers(-12, 12, (16, 16, 1))
        tex[..., :3] = np.clip(np.asarray(rgb)[None, None] + noise, 0, 255)
        tex[..., 3] = int(alpha * 255)
        self.textures.append(tex)
        mat = dict(
            texture_index=len(self.textures) - 1,
            emittance=props.get("emittance", 0.0),
            specular=props.get("specular", 0.0),
            roughness=props.get("roughness", 0.0),
            metalness=props.get("metalness", 0.0),
            ior=props.get("ior", 1.000293),
            flags=(FLAG_OPAQUE | FLAG_SOLID)
            | (FLAG_REFRACTIVE if props.get("refractive") else 0),
        )
        self.materials.append(mat)
        self._by_key[key] = len(self.materials) - 1
        return self._by_key[key]


def compile_world_assets(blockstate_map: dict[str, int], pack_dir: str):
    """Pack-backed world compiler: blockstates -> (materials, atlas,
    leaf_material, BlockModels).

    Each blockstate's JSON chain resolves to quads; full-cube models
    collapse to FLAG_SIMPLE with per-face materials, everything else becomes
    a quad model (stairs, slabs, cross-plants), truncated to its first
    ``MAX_MODEL_QUADS`` quads as the JAX package does.  Blocks the pack lacks assets for fall
    back to the phase-1 color palette as simple cubes.
    """
    from ..ops.texture import build_atlas
    from .biomes import TintResolver
    from .blockmodels import MAX_MODEL_QUADS, ModelBuilder
    from .resourcepack import ResourcePack, compile_blockstate

    pack = ResourcePack(pack_dir)
    pm = _PackMaterials(pack)
    tints = TintResolver(pack)
    builder = ModelBuilder()
    n_states = max(blockstate_map.values()) + 1 if blockstate_map else 1
    # model 0: dummy simple cube on the default magenta material (leaf 0 = air
    # never resolves, but the table must be total)
    default_model = builder.add_simple(0)
    leaf_model = np.full(n_states, default_model, np.int32)
    leaf_material = np.zeros(n_states, np.int32)

    n_pack = n_quad = 0
    for name, state_id in sorted(blockstate_map.items(), key=lambda kv: kv[1]):
        if state_id == 0:
            continue
        # per-biome variant ids are keyed "state@biome" (mca.remap_sections);
        # the biome picks the colormap tint, the state picks the model
        state_name, _, biome = name.partition("@")
        base = state_name.split("#", 1)[0]
        _, props = VANILLA_COLORS.get(base, (None, {}))
        tint_rgb = tints.tint_rgb(base, biome or None)
        quads = compile_blockstate(
            pack,
            state_name,
            lambda tex, tint=-1: pm.material_of_texture(
                tex, tint, props, tint_rgb=tint_rgb if tint >= 0 else None
            ),
        )
        if quads is None:
            mat = pm.palette_material(base)
            leaf_model[state_id] = builder.add_simple(mat)
            leaf_material[state_id] = mat
            continue
        n_pack += 1
        face_ids = [_cube_face_id(q) for q in quads]
        if len(quads) == 6 and sorted(face_ids, key=lambda f: (f is None, f)) == list(range(6)):
            fm = [0] * 6
            for q, fid in zip(quads, face_ids):
                fm[fid] = q["material"]
            leaf_model[state_id] = builder.add_simple(fm)
            leaf_material[state_id] = fm[3]  # representative: up face
        else:
            n_quad += 1
            if len(quads) > MAX_MODEL_QUADS:
                quads = quads[:MAX_MODEL_QUADS]
            leaf_model[state_id] = builder.add_quad_model(quads)
            leaf_material[state_id] = quads[0]["material"]

    models = builder.build(leaf_model)
    atlas = build_atlas(pm.textures, size=None)  # native resolutions
    return make_material_table(pm.materials), atlas, leaf_material, models


def minecraft_scene_from_region(path: str, depth: int = 9, pack_dir: str | None = None):
    """Load a region file/world dir into a renderable Scene + default camera.

    ``pack_dir``: optional resource-pack root (``assets/<ns>/{blockstates,
    models,textures}``); blockstates with pack assets get real geometry and
    textures via :func:`compile_world_assets`, the rest fall back to the
    color palette.  Without a pack every blockstate takes the color palette.

    The palette textures' noise is seeded with ``abs(hash(base name))``, as
    in the JAX package: Python salts ``str`` hashes per process, so two
    processes give the same textures only under one ``PYTHONHASHSEED``."""
    from .camera import Camera
    from .mca import load_world
    from .scene import make_scene

    # with a pack, tinted blockstates split into per-biome variants so the
    # compiler can bake real colormap tints (models/biomes.py)
    tree, blockstate_map = load_world(
        path, depth=depth, biome_variants=bool(pack_dir)
    )
    if tree is None:
        raise ValueError(f"region at {path} contains no blocks")
    if pack_dir:
        materials, atlas, leaf_material, models = compile_world_assets(
            blockstate_map, pack_dir
        )
        scene = make_scene(
            tree, materials, atlas, leaf_material=leaf_material, models=models
        )
    else:
        materials, atlas, leaf_material = compile_block_palette(blockstate_map)
        scene = make_scene(tree, materials, atlas, leaf_material=leaf_material)
    s = 1 << depth
    camera = Camera.look_at(
        eye=(-s * 0.18, s * 0.55, -s * 0.18), center=(s * 0.5, s * 0.22, s * 0.5)
    )
    return scene, camera
