"""The world path (``--world`` / ``--pack``) against the JAX package: NBT,
region parsing (numpy and C++), the region octree, the block palette,
resource packs with biome tints, ``minecraft_scene_from_region`` and
``trace_paths`` on a fixture world, on the same inputs.

Gates: bytes, trees, sections, octree arrays, blockstate maps and scene
tables exact (the palette textures' noise is seeded with ``hash()``, which
is the same within one process); frames under the integrator gate (rtol
and atol 2e-3 per lane, at most 2 bad lanes).  The regions are written in
code with ``make_region_fixture``; one JAX render for the file.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.models import blockpalette as jax_palette
from octree_pathtracing_tpu.models import mca as jax_mca
from octree_pathtracing_tpu.models import nbt as jax_nbt
from octree_pathtracing_tpu.models.camera import pixel_grid_rays as jax_pixel_grid_rays
from octree_pathtracing_tpu.models.emitters import build_emitter_table as jax_build_emitter_table
from octree_pathtracing_tpu.models.sun import SunSampling as JaxSunSampling
from octree_pathtracing_tpu.octree.build import expand_by as jax_expand_by
from octree_pathtracing_tpu.render import draw_uniforms as jax_draw_uniforms
from octree_pathtracing_tpu.render import trace_paths as jax_trace_paths
from octree_pathtracing_tpu_torch.models import blockpalette, mca, nbt
from octree_pathtracing_tpu_torch.models.convert import scene_from_jax_arrays
from octree_pathtracing_tpu_torch.models.emitters import with_emitter_sampling
from octree_pathtracing_tpu_torch.models.sun import SunSampling
from octree_pathtracing_tpu_torch.octree import expand_by
from octree_pathtracing_tpu_torch.ops.texture import Atlas
from octree_pathtracing_tpu_torch.render import trace_paths_census

BLOCKS = ["minecraft:air", "minecraft:bedrock", "minecraft:stone", "minecraft:dirt", "minecraft:grass_block",
          "minecraft:sand", "minecraft:water", "minecraft:oak_log#axis=y", "minecraft:oak_leaves",
          "minecraft:glass", "minecraft:glowstone", "minecraft:lava", "minecraft:mossy_cobblestone"]


def _terrain_section():
    """A 16^3 section of a survival world (YZX indices into BLOCKS): bedrock,
    stone, dirt and grass on a slope, a sandy pool of water, an oak with
    leaves, a glass box round a glowstone, lava and an unknown block."""
    g = np.zeros((16, 16, 16), np.uint16)  # [x, y, z]
    x, z = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    h = 5 + (x + z) // 6
    for y in range(16):
        g[:, y, :] = np.where(y < h - 2, 2, np.where(y < h, 3, np.where(y == h, 4, 0)))
    g[:, 0, :] = 1
    g[1:5, 4:7, 1:5] = np.where(g[1:5, 4:7, 1:5] == 0, 6, g[1:5, 4:7, 1:5])
    g[1:5, 3, 1:5] = 5
    g[10, 10:13, 4] = 7
    g[9:12, 12:14, 3:6] = np.where(g[9:12, 12:14, 3:6] == 0, 8, g[9:12, 12:14, 3:6])
    g[5:8, 11:14, 10:13] = 9
    g[6, 12, 11] = 10
    g[13, 9, 13] = 11
    g[2, 8, 12] = 12
    return g.transpose(1, 2, 0).ravel()  # YZX


def _write(tmp, name, buf):
    path = os.path.join(tmp, name)
    with open(path, "wb") as f:
        f.write(buf)
    return path


@pytest.fixture(scope="module")
def region(tmp_path_factory):
    """One chunk's lowest section holds the terrain (so the world fits a
    depth-4 octree); a second chunk two sections with per-cell biomes."""
    rng = np.random.default_rng(0)
    biomes = (["minecraft:plains", "minecraft:badlands", "minecraft:forest"], rng.integers(0, 3, 64))
    chunks = {(0, 0): {-4: (BLOCKS, _terrain_section())},
              (3, 1): {0: (BLOCKS, rng.integers(0, len(BLOCKS), 4096), biomes),
                       7: (BLOCKS[:5], rng.integers(0, 5, 4096), "minecraft:jungle")}}
    tmp = str(tmp_path_factory.mktemp("world"))
    return {"terrain": _write(tmp, "r.0.0.mca", jax_mca.make_region_fixture({(0, 0): chunks[(0, 0)]})),
            "both": jax_mca.make_region_fixture(chunks), "tmp": tmp}


def test_nbt_bytes_and_trees_equal_jax():
    root = {"name": "hello", "num": 42, "big": 2**40, "neg": -7, "pi": 3.5, "flag": True,
            "arr": np.arange(5, dtype=np.int64), "ints": np.arange(3, dtype=np.int32),
            "bytes": np.arange(-3, 3, dtype=np.int8), "empty": [],
            "nested": {"a": 1, "list": [{"x": 1}, {"x": 2}], "strs": ["a", "b"]}}
    buf = nbt.write_nbt(root, "root")
    assert buf == jax_nbt.write_nbt(root, "root")

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b

    same(nbt.read_nbt(buf), jax_nbt.read_nbt(buf))
    assert nbt.read_nbt(buf)["big"] == 2**40


def _same_sections(got, want):
    key = lambda s: (s.chunk_x, s.chunk_z, s.y_pos)  # noqa: E731
    assert [key(s) for s in sorted(got, key=key)] == [key(s) for s in sorted(want, key=key)]
    for a, b in zip(sorted(got, key=key), sorted(want, key=key)):
        assert a.palette == b.palette and a.biome_palette == b.biome_palette
        np.testing.assert_array_equal(a.indices, b.indices)
        if b.biome_indices is None:
            assert a.biome_indices is None
        else:
            np.testing.assert_array_equal(a.biome_indices, b.biome_indices)


def _same_tree(got, want):
    np.testing.assert_array_equal(got.child_mask, want.child_mask)
    np.testing.assert_array_equal(got.child_data, want.child_data)
    assert (got.root, got.depth) == (want.root, want.depth)


@pytest.mark.parametrize("biome_variants", [False, True])
def test_region_octree_equals_jax(region, biome_variants):
    buf = region["both"]
    _same_sections(mca.parse_region_bytes(buf), jax_mca.parse_region_bytes(buf))
    got, got_map = mca.build_region_octree(buf, use_native=False, biome_variants=biome_variants)
    want, want_map = jax_mca.build_region_octree(buf, use_native=False, biome_variants=biome_variants)
    _same_tree(got, want)
    assert got_map == want_map
    assert any("@minecraft:badlands" in k for k in got_map) == biome_variants
    assert mca.parse_sections(buf, use_native=False)[1:] == ("numpy", "not asked for")


def _native_parser_or_skip():
    """The C++ parser's binding; skips only where g++ or zlib's header is
    missing (any other build failure fails the test)."""
    from octree_pathtracing_tpu_torch.models import native

    if shutil.which("g++") is None:
        pytest.skip("no g++: the numpy parser reads regions")
    try:
        native.get_lib()
    except RuntimeError as e:
        if "zlib.h" in str(e):
            pytest.skip("no zlib header: the numpy parser reads regions")
        raise
    return native.parse_region_native


def test_native_parser_equals_numpy_parser(region):
    """The C++ parser, built into build/native/ at first use, gives the numpy
    parser's sections, biome palettes included, and the same octree."""
    buf = region["both"]
    parse_region_native = _native_parser_or_skip()

    _same_sections(parse_region_native(buf), mca.parse_region_bytes(buf))
    assert mca.parse_sections(buf)[1:] == ("native", None)
    for biome_variants in (False, True):
        tree, bmap = mca.build_region_octree(buf, biome_variants=biome_variants)
        want, want_map = jax_mca.build_region_octree(buf, use_native=False, biome_variants=biome_variants)
        _same_tree(tree, want)
        assert bmap == want_map


def test_two_region_stitch_and_expand_by(tmp_path):
    """test_world_stitch.py's world: stone in r.0.0, dirt in r.1.0, one
    octree of depth 10; and expand_by's wrapped roots."""
    ind = np.zeros(4096, np.uint16)
    ind[0] = 1
    d = tmp_path / "region"
    d.mkdir()
    for name, block in (("r.0.0.mca", "minecraft:stone"), ("r.1.0.mca", "minecraft:dirt")):
        (d / name).write_bytes(mca.make_region_fixture({(0, 0): {0: (["minecraft:air", block], ind)}}))
    for native in (False, True):  # the numpy parser stands in where the C++ one does not build
        got, got_map = mca.load_world(str(tmp_path), use_native=native)
        want, want_map = jax_mca.load_world(str(tmp_path), use_native=False)
        _same_tree(got, want)
        assert got.depth == 10 and got_map == want_map
    _same_tree(expand_by(got, 2), jax_expand_by(want, 2))


def test_block_palette_equals_jax(region):
    _, bmap = jax_mca.build_region_octree(region["both"], use_native=False)
    got_mats, got_atlas, got_leaf = blockpalette.compile_block_palette(bmap)
    want_mats, want_atlas, want_leaf = jax_palette.compile_block_palette(bmap)
    np.testing.assert_array_equal(got_leaf, want_leaf)
    np.testing.assert_array_equal(got_atlas.numpy(), np.asarray(want_atlas))
    for f in dataclasses.fields(got_mats):
        np.testing.assert_array_equal(getattr(got_mats, f.name).numpy(),
                                      np.asarray(getattr(want_mats, f.name)).astype(np.float32
                                                                                    if f.name != "flags" else np.int32),
                                      err_msg=f.name)


def _write_json(root, rel, obj):
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    with open(p, "w") as f:
        json.dump(obj, f)


def _write_png(root, rel, rgba, size=16):
    from PIL import Image

    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    img = np.zeros((size, size, 4), np.uint8)
    img[...] = rgba
    Image.fromarray(img, "RGBA").save(p)


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """test_pack_world.py's pack (a stone cube, the rotated-element cross
    plant) with a tinted grass block, an oak log with a rotated variant,
    leaves with uvlock, a slab, a grass colormap and a 32^2 texture."""
    root = str(tmp_path_factory.mktemp("pack"))
    faces = ("down", "up", "north", "south", "west", "east")
    _write_json(root, "assets/minecraft/models/block/cube.json",
                {"elements": [{"from": [0, 0, 0], "to": [16, 16, 16],
                               "faces": {f: {"texture": "#" + f} for f in faces}}]})
    _write_json(root, "assets/minecraft/models/block/cube_all.json",
                {"parent": "block/cube", "textures": {f: "#all" for f in faces}})
    for name in ("stone", "dirt", "sand"):
        _write_json(root, f"assets/minecraft/models/block/{name}.json",
                    {"parent": "block/cube_all", "textures": {"all": f"block/{name}"}})
        _write_json(root, f"assets/minecraft/blockstates/{name}.json", {"variants": {"": {"model": f"block/{name}"}}})
    cross = [{"from": [0.8, 0, 8], "to": [15.2, 16, 8],
              "rotation": {"origin": [8, 8, 8], "axis": "y", "angle": a, "rescale": True},
              "faces": {"north": {"texture": "#cross"}, "south": {"texture": "#cross"}}} for a in (45, -45)]
    _write_json(root, "assets/minecraft/models/block/cross.json", {"textures": {"particle": "#cross"}, "elements": cross})
    _write_json(root, "assets/minecraft/models/block/short_grass.json",
                {"parent": "block/cross", "textures": {"cross": "block/short_grass"}})
    _write_json(root, "assets/minecraft/blockstates/short_grass.json",
                {"variants": {"": {"model": "block/short_grass"}}})
    _write_json(root, "assets/minecraft/models/block/grass_block.json",
                {"parent": "block/cube", "textures": {"all": "block/grass_top"},
                 "elements": [{"from": [0, 0, 0], "to": [16, 16, 16],
                               "faces": {f: {"texture": "#all", "tintindex": 0} for f in faces}}]})
    _write_json(root, "assets/minecraft/blockstates/grass_block.json",
                {"variants": {"": {"model": "block/grass_block"}}})
    _write_json(root, "assets/minecraft/models/block/oak_log.json",
                {"parent": "block/cube", "textures": {"down": "#end", "up": "#end", "north": "#side",
                                                      "south": "#side", "west": "#side", "east": "#side",
                                                      "end": "block/oak_log_top", "side": "block/oak_log"}})
    _write_json(root, "assets/minecraft/blockstates/oak_log.json",
                {"variants": {"axis=y": {"model": "block/oak_log"},
                              "axis=x": {"model": "block/oak_log", "x": 90, "y": 90}}})
    _write_json(root, "assets/minecraft/models/block/oak_leaves.json",
                {"parent": "block/cube_all", "textures": {"all": "block/oak_leaves"}})
    _write_json(root, "assets/minecraft/blockstates/oak_leaves.json",
                {"variants": {"": {"model": "block/oak_leaves", "y": 90, "uvlock": True}}})
    _write_json(root, "assets/minecraft/models/block/slab.json",
                {"elements": [{"from": [0, 0, 0], "to": [16, 8, 16],
                               "faces": {f: {"texture": "#all", "uv": [0, 8, 16, 16]} for f in faces}}],
                 "textures": {"all": "block/stone"}})
    _write_json(root, "assets/minecraft/blockstates/stone_slab.json",
                {"multipart": [{"when": {"type": "bottom|double"}, "apply": {"model": "block/slab"}}]})
    for name, rgba in (("stone", (200, 30, 30, 255)), ("dirt", (120, 80, 40, 255)), ("sand", (220, 210, 160, 255)),
                       ("short_grass", (30, 200, 30, 255)), ("grass_top", (255, 255, 255, 255)),
                       ("oak_log", (100, 80, 50, 255)), ("oak_log_top", (150, 120, 70, 255))):
        _write_png(root, f"assets/minecraft/textures/block/{name}.png", rgba)
    _write_png(root, "assets/minecraft/textures/block/oak_leaves.png", (60, 140, 40, 200), size=32)
    cm = np.zeros((256, 256, 4), np.uint8)
    cm[..., 0] = np.arange(256, dtype=np.uint8)[None, :]
    cm[..., 1] = (255 - np.arange(256))[:, None].astype(np.uint8)
    cm[..., 2], cm[..., 3] = 64, 255
    from PIL import Image

    os.makedirs(os.path.join(root, "assets/minecraft/textures/colormap"))
    Image.fromarray(cm, "RGBA").save(os.path.join(root, "assets/minecraft/textures/colormap/grass.png"))
    return root


def _same_models(got, want):
    for f in ("leaf_model", "flags", "face_material", "quad_start", "quad_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    for f in ("origin", "u", "v", "material_id", "tex_u_range", "tex_v_range"):
        np.testing.assert_array_equal(getattr(got.quads, f).numpy(), np.asarray(getattr(want.quads, f)), err_msg=f)
    for f in ("w", "normal", "d"):  # derived by each package's make_quads
        np.testing.assert_allclose(getattr(got.quads, f).numpy(), np.asarray(getattr(want.quads, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)


def _same_materials(got, want):
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)).astype(getattr(got, f.name).numpy().dtype),
                                      err_msg=f.name)


def test_world_assets_from_a_pack_equal_jax(pack):
    """Pack blockstates (cubes with per-face materials, the cross plant, a
    multipart slab, a rotated log, uvlock leaves), biome tints from the
    colormap, and blocks without assets on the color palette."""
    bmap = {"minecraft:air": 0, "minecraft:stone": 1, "minecraft:short_grass": 2,
            "minecraft:grass_block@minecraft:plains": 3, "minecraft:grass_block@minecraft:badlands": 4,
            "minecraft:oak_log#axis=x": 5, "minecraft:oak_leaves@minecraft:forest": 6,
            "minecraft:stone_slab#type=bottom": 7, "minecraft:glowstone": 8, "minecraft:water": 9}
    got = blockpalette.compile_world_assets(bmap, pack)
    want = jax_palette.compile_world_assets(bmap, pack)
    _same_materials(got[0], want[0])
    assert isinstance(got[1], Atlas)
    np.testing.assert_array_equal(got[1].data.numpy(), np.asarray(want[1].data))
    np.testing.assert_array_equal(got[1].sizes.numpy(), np.asarray(want[1].sizes))
    np.testing.assert_array_equal(got[2], want[2])
    _same_models(got[3], want[3])
    # the two grass blocks took different colormap tints
    mats = got[2]
    assert mats[3] != mats[4] and got[0].tint_index[mats[3]] == 0


@pytest.fixture(scope="module")
def world_scenes(region):
    """The fixture world through both packages' ``minecraft_scene_from_region``
    at depth 4."""
    return (blockpalette.minecraft_scene_from_region(region["terrain"], depth=4),
            jax_palette.minecraft_scene_from_region(region["terrain"], depth=4))


def _same_scene(got, jscene):
    carried = scene_from_jax_arrays(jscene)
    np.testing.assert_array_equal(got.nodes.numpy(), carried.nodes.numpy())
    assert (got.root, got.depth) == (carried.root, carried.depth)
    np.testing.assert_array_equal(got.leaf_material.numpy(), carried.leaf_material.numpy())
    _same_materials(got.materials, jscene.materials)
    g_atlas = got.atlas.data if isinstance(got.atlas, Atlas) else got.atlas
    c_atlas = carried.atlas.data if isinstance(carried.atlas, Atlas) else carried.atlas
    np.testing.assert_array_equal(g_atlas.numpy(), c_atlas.numpy())
    assert (got.opaque_only, got.shadow_binary, got.has_quad_models) == (
        jscene.opaque_only, jscene.shadow_binary, jscene.has_quad_models)


def test_scene_from_region_equals_jax(world_scenes, region, pack):
    (scene, cam), (jscene, jcam) = world_scenes
    _same_scene(scene, jscene)
    # no palette texel is transparent enough to reject a hit (K1 on the
    # bounces), but leaves, glass and water let sun light through (K3s)
    assert scene.opaque_only and not scene.shadow_binary and scene.models is None
    for f in ("eye", "forward", "right", "up"):
        if hasattr(jcam, f):
            np.testing.assert_array_equal(getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)), err_msg=f)
    # with a pack: per-biome variants and the pack's models
    scene, _ = blockpalette.minecraft_scene_from_region(region["terrain"], depth=4, pack_dir=pack)
    jscene, _ = jax_palette.minecraft_scene_from_region(region["terrain"], depth=4, pack_dir=pack)
    _same_scene(scene, jscene)
    _same_models(scene.models, jscene.models)


def test_trace_paths_on_the_world_matches_jax_per_lane(world_scenes):
    """The fixture world under the HIGH_QUALITY sun and one-emitter NEE
    (a glowstone and a lava block), 16x16 lanes, 2 bounces: translucent
    leaves, refractive water and glass on the bounces and in the stateful
    shadow walks."""
    (scene, _), (jscene, jcam) = world_scenes
    jscene = dataclasses.replace(
        jscene, sun_sampling=JaxSunSampling.high_quality(), emitter_sampling="one",
        emitters=jax_build_emitter_table(jscene.octree, jscene.leaf_material, jscene.materials, jscene.models))
    scene = with_emitter_sampling(dataclasses.replace(scene, sun_sampling=SunSampling.high_quality()), "one")
    assert scene.emitters.count == jscene.emitters.count == 2
    o, d = (np.array(x) for x in jax_pixel_grid_rays(jcam, 16, 16))
    u = np.array(jax_draw_uniforms(jax.random.PRNGKey(3), o.shape[0], n_bounces=2))
    want = np.asarray(jax.jit(lambda o, d, u: jax_trace_paths(jscene, o, d, u, tiles=1))(o, d, u))
    got, live = trace_paths_census(scene, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(u))
    got = got.numpy()
    assert np.isfinite(got).all() and got.mean() > 0.01 and live[1] > 0
    bad = ~np.all(np.isclose(got, want, rtol=2e-3, atol=2e-3), axis=-1)
    assert bad.sum() <= 2, (bad.sum(), np.flatnonzero(bad)[:5])
