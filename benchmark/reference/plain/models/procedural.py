"""The two terrain scenes of the benchmark's configurations, frozen from the
port's ``models/procedural.py``: the heightfield chunk and its cutout
variant, each octree built from the scene grid by the frozen builder."""

from __future__ import annotations

import os

import numpy as np

from ..octree.build import build_from_dense
from ..octree.node_pool import Octree
from ..ops.texture import build_atlas
from .camera import Camera
from .materials import FLAG_OPAQUE, FLAG_SOLID, air, make_material_table
from .scene import make_scene

def _solid_texture(rgb, size=16):
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = rgb
    img[..., 3] = 255
    return img


def octree_from_grid(grid: np.ndarray) -> Octree:
    """Sparse octree of a dense ``(s, s, s)`` grid of leaf values (0 is
    empty, ``s`` a power of two), built on the host by the numpy builder."""
    return build_from_dense(grid)


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
