"""Procedural scenes (port of ``models/procedural.py``): the voxel sphere
and its analytic-primitive form, the Cornell box, the Minecraft-style
terrain chunk and its cutout variant (trees with alpha-holed leaf
canopies), the two emitter-sampling rooms (a ceiling light, scattered floor
lights) and the cross-plant field of block models, built on the host by the
port's numpy octree builder (``octree/``)."""

from __future__ import annotations

import os

import numpy as np

from ..octree import Octree, build_from_dense
from ..ops.texture import build_atlas
from .camera import Camera
from .blockmodels import ModelBuilder, cross_plant_quads
from .materials import FLAG_OPAQUE, FLAG_SOLID, air, make_material_table
from .prims import make_primitives
from .scene import make_scene
from .sun import SunSampling, make_sun


def _checker_texture(size=16, c0=(200, 60, 60), c1=(240, 230, 210)):
    img = np.zeros((size, size, 4), np.uint8)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    m = ((yy // 4) + (xx // 4)) % 2 == 0
    img[m] = (*c0, 255)
    img[~m] = (*c1, 255)
    return img


def _solid_texture(rgb, size=16):
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = rgb
    img[..., 3] = 255
    return img


def _earthmap_like(size=16):
    """Blue/green blobby texture standing in for an earth map."""
    rng = np.random.default_rng(0)
    img = np.zeros((size, size, 4), np.uint8)
    land = rng.random((size, size)) > 0.55
    img[..., 2] = np.where(land, 40, 180)
    img[..., 1] = np.where(land, 160, 80)
    img[..., 0] = np.where(land, 60, 30)
    img[..., 3] = 255
    return img


def octree_from_grid(grid: np.ndarray) -> Octree:
    """Sparse octree of a dense ``(s, s, s)`` grid of leaf values (0 is
    empty, ``s`` a power of two), built on the host by the numpy builder."""
    return build_from_dense(grid)


def sphere_scene(depth: int = 6, earthmap: np.ndarray | None = None):
    """Voxelized sphere above a textured ground slab."""
    s = 1 << depth
    grid = np.zeros((s, s, s), np.uint32)
    grid[:, 0 : max(1, s // 16), :] = 1  # ground slab: material 1
    c = np.array([s / 2, s / 2.5, s / 2])
    r = s / 4.5
    xs, ys, zs = np.meshgrid(np.arange(s), np.arange(s), np.arange(s), indexing="ij")
    inside = (xs + 0.5 - c[0]) ** 2 + (ys + 0.5 - c[1]) ** 2 + (zs + 0.5 - c[2]) ** 2 < r * r
    grid[inside] = 2  # sphere: material 2
    tree = octree_from_grid(grid)

    textures = [
        _solid_texture((255, 0, 255)),  # 0: default magenta
        _earthmap_like() if earthmap is None else earthmap,  # ground
        _checker_texture(),  # sphere
    ]
    materials = [air(), dict(texture_index=1), dict(texture_index=2, specular=0.0)]
    # a supplied earthmap keeps its native resolution
    atlas = build_atlas(textures, size=16 if earthmap is None else None)
    scene = make_scene(tree, make_material_table(materials), atlas)
    camera = Camera.look_at(eye=(s * 0.5, s * 0.55, -s * 0.9), center=(s * 0.5, s * 0.35, s * 0.5))
    return scene, camera


def analytic_sphere_scene(depth: int = 5, earthmap: np.ndarray | None = None):
    """A true (non-voxel) sphere primitive above the textured voxel ground
    slab, and a free-standing quad facing the camera: the scene's analytic
    primitives (``models/prims.py``) beside the octree."""
    s = 1 << depth
    grid = np.zeros((s, s, s), np.uint32)
    grid[:, 0 : max(1, s // 16), :] = 1
    tree = octree_from_grid(grid)

    textures = [
        _solid_texture((255, 0, 255)),
        _earthmap_like() if earthmap is None else earthmap,
        _checker_texture(),
        _solid_texture((220, 200, 80)),
    ]
    materials = [air(), dict(texture_index=1), dict(texture_index=2, specular=0.0), dict(texture_index=3)]
    prims = make_primitives(
        spheres=[((s * 0.5, s * 0.45, s * 0.5), s / 4.5, 2)],
        quads=(
            # u x v = -z: it faces the camera (a backface is culled)
            np.array([[s * 0.1, s * 0.1, s * 0.75]], np.float32),  # origin
            np.array([[0.0, s * 0.3, 0.0]], np.float32),  # u edge (up)
            np.array([[s * 0.25, 0.0, 0.0]], np.float32),  # v edge (right)
            np.array([3], np.int32),
        ),
    )
    atlas = build_atlas(textures, size=16 if earthmap is None else None)
    scene = make_scene(tree, make_material_table(materials), atlas, prims=prims)
    camera = Camera.look_at(eye=(s * 0.51, s * 0.55, -s * 0.9), center=(s * 0.5, s * 0.35, s * 0.5))
    return scene, camera


def cornell_scene(depth: int = 6):
    """Cornell box: white floor/ceiling/back, red/green walls, an emissive
    ceiling patch and two boxes."""
    s = 1 << depth
    grid = np.zeros((s, s, s), np.uint32)
    W, R, G, L, B1, B2 = 1, 2, 3, 4, 5, 6
    grid[:, 0, :] = W  # floor
    grid[:, s - 1, :] = W  # ceiling
    grid[:, :, s - 1] = W  # back wall
    grid[0, :, :] = R  # left red
    grid[s - 1, :, :] = G  # right green
    q = s // 4
    grid[s // 2 - q // 2 : s // 2 + q // 2, s - 1, s // 2 - q // 2 : s // 2 + q // 2] = L
    grid[q : 2 * q, 1 : s // 2, s // 2 : s // 2 + q] = B1  # tall box
    grid[s - 2 * q : s - q, 1 : s // 4, q : 2 * q] = B2  # short box
    tree = octree_from_grid(grid)

    textures = [
        _solid_texture((255, 0, 255)),
        _solid_texture((230, 230, 230)),  # white
        _solid_texture((200, 40, 40)),  # red
        _solid_texture((40, 200, 40)),  # green
        _solid_texture((255, 255, 255)),  # light
        _solid_texture((180, 180, 200)),
        _solid_texture((200, 180, 160)),
    ]
    materials = [
        air(),
        dict(texture_index=1),
        dict(texture_index=2),
        dict(texture_index=3),
        dict(texture_index=4, emittance=8.0),
        dict(texture_index=5),
        dict(texture_index=6),
    ]
    sun = make_sun(altitude=-np.pi / 3)  # below the horizon: lit by the patch
    scene = make_scene(tree, make_material_table(materials), build_atlas(textures), sun=sun)
    # eye slightly off the voxel-centre axes: an exactly centred camera sends
    # many rays along voxel boundary planes
    camera = Camera.look_at(
        eye=(s * 0.513, s * 0.492, -s * 1.2), center=(s * 0.507, s * 0.496, s * 0.5)
    )
    return scene, camera


def terrain_grid(depth: int, seed: int = 0) -> np.ndarray:
    """Minecraft-ish heightfield terrain: stone/dirt/grass columns, emissive
    glowstone and a water pool."""
    rng = np.random.default_rng(seed)
    s = 1 << depth
    GRASS, DIRT, STONE, GLOW, WATER = 1, 2, 3, 4, 5
    hx = np.linspace(0, 3.0 * max(1, s // 32), s)
    hz = np.linspace(0, 2.0 * max(1, s // 32), s)
    height = (
        s // 3
        + np.sin(hx)[:, None] * (s / 10)
        + np.cos(hz)[None, :] * (s / 16)
        + rng.normal(0, max(0.5, s / 64), (s, s))
    ).astype(np.int64).clip(2, s - 3)
    # slab-by-slab assembly keeps the temporaries small
    grid = np.zeros((s, s, s), np.uint32)
    h16 = height.astype(np.int16)
    for y in range(s):
        grid[:, y, :] = (
            (y < h16 - 2) * np.uint32(STONE)
            + ((y >= h16 - 2) & (y < h16)) * np.uint32(DIRT)
            + (y == h16) * np.uint32(GRASS)
        )
    n_glow = max(2, s // 4)  # glowstone scattered above ground
    gx = rng.integers(0, s, n_glow)
    gz = rng.integers(0, s, n_glow)
    grid[gx, (height[gx, gz] + 2).clip(0, s - 1), gz] = GLOW
    grid[s // 4 : s // 2, s // 3 - 1 : s // 3 + 1, s // 4 : s // 2] = WATER  # pool
    return grid


def _cached_octree(name: str, grid_fn, depth: int, seed: int, cache_dir: str | None) -> Octree:
    """``octree_from_grid(grid_fn(depth, seed))``, cached as npz under
    ``cache_dir`` when one is given."""
    cache_path = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache_path = os.path.join(cache_dir, f"{name}_d{depth}_s{seed}.npz")
        if os.path.exists(cache_path):
            z = np.load(cache_path)
            return Octree(z["mask"], z["data"], int(z["root"]), int(z["depth"]))
    tree = octree_from_grid(grid_fn(depth, seed))
    if cache_path:
        tmp = f"{cache_path}.{os.getpid()}.tmp.npz"
        np.savez_compressed(
            tmp, mask=tree.child_mask, data=tree.child_data, root=tree.root, depth=tree.depth
        )
        os.replace(tmp, cache_path)
    return tree


def minecraft_chunk_scene(depth: int = 5, seed: int = 0, cache_dir: str | None = None):
    """Minecraft-ish terrain chunk: grass/dirt/stone heightfield, scattered
    emissive glowstone, a water pool.

    ``cache_dir``: optional directory caching the built node pool as npz."""
    s = 1 << depth
    tree = _cached_octree("terrain", terrain_grid, depth, seed, cache_dir)
    textures = [
        _solid_texture((255, 0, 255)),
        _solid_texture((60, 180, 60)),
        _solid_texture((134, 96, 67)),
        _solid_texture((130, 130, 130)),
        _solid_texture((255, 220, 120)),
        _solid_texture((50, 90, 220)),
    ]
    materials = [
        air(),
        dict(texture_index=1),
        dict(texture_index=2),
        dict(texture_index=3),
        dict(texture_index=4, emittance=6.0),
        dict(texture_index=5, ior=1.33, specular=0.1, flags=FLAG_OPAQUE | FLAG_SOLID),
    ]
    scene = make_scene(tree, make_material_table(materials), build_atlas(textures))
    camera = Camera.look_at(eye=(-s * 0.4, s * 0.8, -s * 0.4), center=(s * 0.5, s * 0.3, s * 0.5))
    return scene, camera


def _cutout_leaf_texture(size=16, seed=3):
    """Leaf-style cutout texture: alpha is exactly {0, 255}, so every leaf
    candidate needs the in-loop alpha test."""
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 1] = rng.integers(120, 200, (size, size))
    img[..., 0] = 30
    img[..., 2] = 30
    img[..., 3] = np.where(rng.random((size, size)) < 0.72, 255, 0)
    return img


def cutout_terrain_grid(depth: int, seed: int = 0) -> np.ndarray:
    """``terrain_grid`` plus trees: opaque trunks (material 6) and leaf
    canopies (material 7) with an alpha-holed texture.  Raises at depth 2,
    as the reference does (``rng.integers(2, s - 3)`` with s = 4)."""
    rng = np.random.default_rng(seed + 1000)
    s = 1 << depth
    TRUNK, LEAF = 6, 7
    grid = terrain_grid(depth, seed)
    # the grass surface per column, read off the grid itself (material 1)
    grass_y = np.argmax(grid[:, ::-1, :] == 1, axis=1)
    surface = (s - 1 - grass_y).astype(np.int64)  # y of grass; s-1 if none
    n_trees = max(2, s // 8)
    tx = rng.integers(2, s - 3, n_trees)
    tz = rng.integers(2, s - 3, n_trees)
    th = rng.integers(3, max(4, s // 12) + 3, n_trees)
    for x, z, h in zip(tx, tz, th):
        y0 = surface[x, z] + 1
        if y0 + h + 2 >= s:
            continue
        grid[x, y0 : y0 + h, z] = TRUNK
        # canopy: a 3-5 wide leafy blob around the trunk top
        r = int(rng.integers(1, 3))
        xs = slice(max(0, x - r), min(s, x + r + 1))
        zs = slice(max(0, z - r), min(s, z + r + 1))
        ys = slice(y0 + h - 1, min(s, y0 + h + 2))
        canopy = grid[xs, ys, zs]
        canopy[canopy == 0] = LEAF
        grid[xs, ys, zs] = canopy
    return grid


def cutout_chunk_scene(depth: int = 5, seed: int = 0, cache_dir: str | None = None):
    """The terrain chunk with trees whose leaf canopies have alpha holes and
    with translucent water: ``opaque_only`` and ``shadow_binary`` are both
    False, so every traversal runs the in-loop alpha accept (kernel K2).

    ``cache_dir``: optional directory caching the built node pool as npz."""
    s = 1 << depth
    tree = _cached_octree("cutout", cutout_terrain_grid, depth, seed, cache_dir)
    water = _solid_texture((50, 90, 220))
    water[..., 3] = 150  # translucent
    textures = [
        _solid_texture((255, 0, 255)),
        _solid_texture((60, 180, 60)),  # grass
        _solid_texture((134, 96, 67)),  # dirt
        _solid_texture((130, 130, 130)),  # stone
        _solid_texture((255, 220, 120)),  # glowstone
        water,
        _solid_texture((90, 60, 30)),  # trunk
        _cutout_leaf_texture(),  # leaves (alpha {0, 255})
    ]
    materials = [
        air(),
        dict(texture_index=1),
        dict(texture_index=2),
        dict(texture_index=3),
        dict(texture_index=4, emittance=6.0),
        dict(texture_index=5, ior=1.33, specular=0.1, flags=FLAG_OPAQUE | FLAG_SOLID),
        dict(texture_index=6),
        dict(texture_index=7),
    ]
    scene = make_scene(tree, make_material_table(materials), build_atlas(textures))
    camera = Camera.look_at(eye=(-s * 0.4, s * 0.8, -s * 0.4), center=(s * 0.5, s * 0.3, s * 0.5))
    return scene, camera


def emissive_room_scene(depth: int = 3):
    """Closed diffuse room lit only by its emissive ceiling: no ray escapes,
    so all light is emitter transport.  Built with ``EmitterSampling.ONE``."""
    s = 1 << depth
    grid = np.zeros((s, s, s), np.uint32)
    W, L = 1, 2
    grid[0, :, :] = W
    grid[s - 1, :, :] = W
    grid[:, 0, :] = W
    grid[:, :, 0] = W
    grid[:, :, s - 1] = W
    grid[:, s - 1, :] = L  # the whole ceiling emits

    tree = octree_from_grid(grid)
    textures = [
        _solid_texture((255, 0, 255)),
        _solid_texture((210, 210, 210)),
        _solid_texture((255, 240, 220)),
    ]
    materials = [air(), dict(texture_index=1), dict(texture_index=2, emittance=4.0)]
    scene = make_scene(
        tree,
        make_material_table(materials),
        build_atlas(textures),
        sun=make_sun(altitude=-np.pi / 2),
        emitter_sampling="one",
    )
    camera = Camera.look_at(eye=(s * 0.52, s * 0.43, s * 0.55), center=(s * 0.21, s * 0.35, s * 0.2))
    return scene, camera


def scattered_lights_scene(depth: int = 5, n_lights: int = 150, seed: int = 1):
    """Closed dark room with ``n_lights`` small emissive blocks scattered over
    the floor, and the camera near one corner: nearby lights dominate, which
    the spatial pick (``models/emitters.build_spatial_grid``) favours.
    Built with ``EmitterSampling.ONE``."""
    rng = np.random.default_rng(seed)
    s = 1 << depth
    grid = np.zeros((s, s, s), np.uint32)
    W, L = 1, 2
    grid[0, :, :] = W
    grid[s - 1, :, :] = W
    grid[:, 0, :] = W
    grid[:, s - 1, :] = W
    grid[:, :, 0] = W
    grid[:, :, s - 1] = W
    lx = rng.integers(1, s - 1, n_lights)
    lz = rng.integers(1, s - 1, n_lights)
    grid[lx, 1, lz] = L  # the lights sit on the floor (y = 1)

    tree = octree_from_grid(grid)
    textures = [
        _solid_texture((255, 0, 255)),
        _solid_texture((140, 140, 140)),
        _solid_texture((255, 230, 180)),
    ]
    materials = [air(), dict(texture_index=1), dict(texture_index=2, emittance=12.0)]
    scene = make_scene(
        tree,
        make_material_table(materials),
        build_atlas(textures),
        sun=make_sun(altitude=-np.pi / 2),
        emitter_sampling="one",
    )
    camera = Camera.look_at(eye=(s * 0.12, s * 0.3, s * 0.12), center=(s * 0.45, s * 0.1, s * 0.45))
    return scene, camera


def plant_scene(depth: int = 3):
    """Block models under the HIGH_QUALITY sun: a stone floor (a simple
    model) and a field of cross plants (quad models, every other cell of the
    floor's inner rows), so that the traversal, the shadow walk and the
    recording walk all run their quad-model accept."""
    s = 1 << depth
    grid = np.zeros((s, s, s), np.uint32)
    grid[:, 0, :] = 1  # stone floor
    grid[1 : s - 1 : 2, 1, 1 : s - 1 : 2] = 2  # plants

    tree = octree_from_grid(grid)
    textures = [
        _solid_texture((255, 0, 255)),
        _solid_texture((128, 128, 128)),
        _solid_texture((40, 200, 40)),
    ]
    materials = [air(), dict(texture_index=1), dict(texture_index=2)]

    mb = ModelBuilder()
    m_air = mb.add_simple(0)
    m_stone = mb.add_simple(1)
    m_plant = mb.add_quad_model(cross_plant_quads(material=2))
    models = mb.build([m_air, m_stone, m_plant])

    scene = make_scene(
        tree,
        make_material_table(materials),
        build_atlas(textures),
        models=models,
        sun_sampling=SunSampling.high_quality(),
    )
    camera = Camera.look_at(eye=(s * 0.51, s * 0.61, -s * 0.9), center=(s * 0.5, s * 0.25, s * 0.5))
    return scene, camera
