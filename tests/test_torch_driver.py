"""The driver surface against the JAX package on the same seeded inputs:
``Config``'s JSON read by the other package both ways; ``EditableOctree``
edit sequences giving the same pools, and the 12-word node codec, the
Morton codecs, ``bits`` and ``colors``, all exactly; the camera's depth of
field, move and rotate within 1e-6; ``mathx`` and the test images within
1e-5; ``linear_to_srgb`` and ``has_flag``; the Renderer's controls; a
render checkpoint resumed bit-equal to an uninterrupted render (as
test_cli_and_io.py does for the JAX package), by the CLI and by the
Renderer."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu import config as jax_config
from octree_pathtracing_tpu.models import camera as jax_camera
from octree_pathtracing_tpu.models import materials as jax_materials
from octree_pathtracing_tpu.models import minecraft_chunk_scene as jax_chunk_scene
from octree_pathtracing_tpu.octree import edit as jax_edit
from octree_pathtracing_tpu.octree import morton as jax_morton
from octree_pathtracing_tpu.octree import node_pool as jax_node_pool
from octree_pathtracing_tpu.ops import texture as jax_texture
from octree_pathtracing_tpu.render import testimages as jax_testimages
from octree_pathtracing_tpu.utils import bits as jax_bits
from octree_pathtracing_tpu.utils import colors as jax_colors
from octree_pathtracing_tpu.utils import mathx as jax_mathx
from octree_pathtracing_tpu_torch import config
from octree_pathtracing_tpu_torch.cli import build_parser, main
from octree_pathtracing_tpu_torch.io.checkpoint import load_render_checkpoint, save_render_checkpoint
from octree_pathtracing_tpu_torch.models import camera, materials, sphere_scene
from octree_pathtracing_tpu_torch.models.convert import camera_from_numpy
from octree_pathtracing_tpu_torch.models.procedural import octree_from_grid
from octree_pathtracing_tpu_torch.models.scene import make_scene
from octree_pathtracing_tpu_torch.octree import (
    EditableOctree,
    Octree,
    compact_by_2,
    decode_morton,
    encode_morton,
    gpu_words_to_pool,
    is_child,
    is_leaf,
    octree_to_gpu_words,
)
from octree_pathtracing_tpu_torch.ops import texture
from octree_pathtracing_tpu_torch.render import Renderer
from octree_pathtracing_tpu_torch.render import testimages
from octree_pathtracing_tpu_torch.render.preview import preview_image
from octree_pathtracing_tpu_torch.utils import bits, colors, mathx

RNG_SEED = 11


# ---- Config


def test_config_json_from_jax_loads_in_the_port():
    c = jax_config.Config()
    c.render.target_spp, c.sun.altitude, c.camera.eye = 17, 0.5, (1.0, 2.0, 3.0)
    c.sampling.emitter_strategy, c.world.path = "one", "r.0.0.mca"
    back = config.Config.from_json(c.to_json())
    assert dataclasses.asdict(back) == dataclasses.asdict(c)
    assert back.camera.eye == (1.0, 2.0, 3.0) and back.render.target_spp == 17


def test_config_json_from_the_port_loads_in_jax():
    c = config.Config()
    c.render.width, c.render.mode, c.sharding.n_devices, c.world.origin = 640, "preview", 4, (8.0, 0.0, 8.0)
    back = jax_config.Config.from_json(c.to_json())
    assert dataclasses.asdict(back) == dataclasses.asdict(c)
    # the same defaults, field names and JSON text
    assert config.Config().to_json() == jax_config.Config().to_json()


def test_config_missing_sections_keep_their_defaults():
    back = config.Config.from_json(json.dumps({"render": {"seed": 3}}))
    assert back.render.seed == 3 and back.render.width == 1280 and back.sun == config.SunConfig()


# ---- the octree pool: edits and codecs


@pytest.fixture(scope="module")
def chunk_pool():
    """The JAX depth-5 terrain's pool, as numpy."""
    jscene, _ = jax_chunk_scene(depth=5)
    t = jscene.octree
    return np.asarray(t.child_mask), np.asarray(t.child_data), int(t.root), int(t.depth)


def _edits(depth: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    side = 1 << depth
    xyz = rng.integers(0, side, (n, 3))
    # a third removals, the rest values of a few kinds (so octants go uniform)
    vals = np.where(rng.random(n) < 0.33, 0, rng.integers(1, 4, n))
    return [(int(x), int(y), int(z), int(v)) for (x, y, z), v in zip(xyz, vals)]


@pytest.mark.parametrize("seed", [0, 1])
def test_editable_octree_matches_jax(chunk_pool, seed):
    mask, data, root, depth = chunk_pool
    ours = EditableOctree(Octree(mask, data, root, depth))
    theirs = jax_edit.EditableOctree(jax_node_pool.Octree(mask, data, root, depth))
    for x, y, z, v in _edits(depth, 300, seed):
        ours.set(x, y, z, v)
        theirs.set(x, y, z, v)
    # filling one whole 2x2x2 octant with one value compacts it upward
    for dx in range(2):
        for dy in range(2):
            for dz in range(2):
                ours.set(8 + dx, 20 + dy, 4 + dz, 5)
                theirs.set(8 + dx, 20 + dy, 4 + dz, 5)
    ours.remove(3, 3, 3)
    theirs.remove(3, 3, 3)
    a, b = ours.to_octree(), theirs.to_octree()
    assert a.root == b.root and a.depth == b.depth
    np.testing.assert_array_equal(a.child_mask, b.child_mask)
    np.testing.assert_array_equal(a.child_data, b.child_data)
    for x, y, z, _ in _edits(depth, 100, seed + 7):
        assert ours.get(x, y, z) == theirs.get(x, y, z)
    assert ours.get(9, 21, 5) == 5


def test_edited_pool_becomes_a_scene():
    """An edited pool is a scene again: a block set in the sphere's view
    changes the preview frame; removed, the frame is the first one."""
    scene, cam = sphere_scene(depth=3)
    grid = np.zeros((8, 8, 8), np.uint32)
    grid[:, 0, :] = 1  # the ground slab
    ed = EditableOctree(octree_from_grid(grid))

    def frame():
        edited = make_scene(ed.to_octree(), scene.materials, scene.atlas, sun=scene.sun,
                            leaf_material=scene.leaf_material)
        return preview_image(edited, cam, 12, 9)

    before = frame()
    block = [(x, y, z) for x in range(2, 6) for y in range(1, 5) for z in range(2, 6)]
    for x, y, z in block:
        ed.set(x, y, z, 2)
    assert all(ed.get(*p) == 2 for p in block) and ed.get(0, 0, 0) == 1
    assert not torch.equal(frame(), before)
    for x, y, z in block:
        ed.remove(x, y, z)
    assert all(ed.get(*p) == 0 for p in block)
    assert torch.equal(frame(), before)


def test_gpu_word_codec_matches_jax(chunk_pool):
    mask, data, root, depth = chunk_pool
    words = octree_to_gpu_words(Octree(mask, data, root, depth))
    np.testing.assert_array_equal(words, jax_node_pool.octree_to_gpu_words(jax_node_pool.Octree(mask, data, root, depth)))
    m2, d2 = gpu_words_to_pool(words)
    jm, jd = jax_node_pool.gpu_words_to_pool(words)
    np.testing.assert_array_equal(m2, jm)
    np.testing.assert_array_equal(d2, jd)
    np.testing.assert_array_equal(m2, mask)  # the round trip
    np.testing.assert_array_equal(d2, data)
    slots = np.arange(8)[None, :]
    np.testing.assert_array_equal(is_child(mask[:, None], slots), jax_node_pool.is_child(mask[:, None], slots))
    np.testing.assert_array_equal(is_leaf(mask[:, None], slots), jax_node_pool.is_leaf(mask[:, None], slots))


def test_morton_codecs_match_jax():
    rng = np.random.default_rng(RNG_SEED)
    xyz = rng.integers(0, 1 << 21, (3, 4096), dtype=np.uint64)
    code = encode_morton(*xyz)
    np.testing.assert_array_equal(code, jax_morton.encode_morton(*xyz))
    for ours, theirs in zip(decode_morton(code), jax_morton.decode_morton(code)):
        np.testing.assert_array_equal(ours, theirs)
    for ours, want in zip(decode_morton(code), xyz):
        np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(compact_by_2(code), jax_morton.compact_by_2(code))


# ---- bits and colors


def test_bits_match_jax():
    rng = np.random.default_rng(RNG_SEED)
    u = np.concatenate([[0, 1, 2, 0xFFFFFFFF], rng.integers(0, 2**32, 1000, dtype=np.uint64)]).astype(np.uint32)
    np.testing.assert_array_equal(bits.find_msb_u32(u), jax_bits.find_msb_u32(u))
    i = np.concatenate([[0, -1, 1, -2**31, 2**31 - 1], rng.integers(-2**31, 2**31, 1000)])
    np.testing.assert_array_equal(bits.find_msb_i32(i), jax_bits.find_msb_i32(i))
    a = np.zeros(8, np.uint32)
    b = np.zeros(8, np.uint32)
    for start in (0, 7, 31, 32, 100, 200, bits.MAX_START):
        value = int(rng.integers(0, 1 << 30))
        bits.write_u30(a, start, value)
        jax_bits.write_u30(b, start, value)
        np.testing.assert_array_equal(a, b)
        assert bits.extract_u30(a, start) == jax_bits.extract_u30(b, start) == value


def test_colors_match_jax():
    rng = np.random.default_rng(RNG_SEED)
    u8 = rng.integers(0, 256, (32, 4), dtype=np.uint8)
    np.testing.assert_array_equal(colors.u8_to_f32(u8), jax_colors.u8_to_f32(u8))
    f = rng.random((32, 4), dtype=np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(colors.f32_to_u8(f), jax_colors.f32_to_u8(f))
    np.testing.assert_array_equal(colors.f32_to_u8(f[:, :3]), jax_colors.f32_to_u8(f[:, :3]))


def test_linear_to_srgb_and_has_flag_match_jax():
    rng = np.random.default_rng(RNG_SEED)
    c = rng.random((64, 3), dtype=np.float32) * 1.4 - 0.2
    np.testing.assert_allclose(texture.linear_to_srgb(torch.from_numpy(c)).numpy(),
                               np.asarray(jax_texture.linear_to_srgb(jnp.asarray(c))), rtol=1e-6, atol=1e-7)
    flags = rng.integers(0, 32, 64).astype(np.int32)
    for bit in (0x01, 0x04, 0x10):
        np.testing.assert_array_equal(materials.has_flag(torch.from_numpy(flags), bit).numpy(),
                                      np.asarray(jax_materials.has_flag(jnp.asarray(flags), bit)))


# ---- the camera


def _cameras():
    jcam = jax_camera.Camera.look_at(eye=(3.0, 5.0, -7.0), center=(8.0, 2.0, 8.0))
    jcam = dataclasses.replace(jcam, aperture=0.4, focal_distance=9.0)
    cam = camera_from_numpy(np.asarray(jcam.eye), np.asarray(jcam.direction), np.asarray(jcam.up), jcam.fov,
                            jcam.aperture, jcam.focal_distance)
    return jcam, cam


def test_camera_carries_its_lens_to_a_device():
    _, cam = _cameras()
    moved = cam.to("cpu")
    assert (moved.aperture, moved.focal_distance) == (0.4, 9.0)


@pytest.mark.parametrize("aperture", [0.4, 0.0])
def test_get_rays_dof_matches_jax(aperture):
    jcam, cam = _cameras()
    jcam, cam = dataclasses.replace(jcam, aperture=aperture), dataclasses.replace(cam, aperture=aperture)
    rng = np.random.default_rng(RNG_SEED)
    xn, yn, u1, u2 = (rng.random(256, dtype=np.float32) for _ in range(4))
    want = jax_camera.get_rays_dof(jcam, jnp.asarray(xn * 2 - 1), jnp.asarray(yn * 2 - 1), jnp.asarray(u1),
                                   jnp.asarray(u2))
    got = camera.get_rays_dof(cam, torch.from_numpy(xn * 2 - 1), torch.from_numpy(yn * 2 - 1), torch.from_numpy(u1),
                              torch.from_numpy(u2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_move_and_rotate_camera_match_jax():
    jcam, cam = _cameras()
    for kw in ({"forward": 2.5}, {"strafe": -1.25, "vertical": 3.0}, {"forward": -0.5, "strafe": 0.75}):
        jm, m = jax_camera.move_camera(jcam, **kw), camera.move_camera(cam, **kw)
        np.testing.assert_allclose(m.eye.numpy(), np.asarray(jm.eye), rtol=1e-6, atol=1e-6)
    for yaw, pitch in ((0.3, 0.2), (-2.0, 1.5), (4.0, -3.0)):  # 1.5 and -3.0 rad pass the +-80 degree clamp
        jr, r = jax_camera.rotate_camera(jcam, yaw, pitch), camera.rotate_camera(cam, yaw, pitch)
        for f in ("direction", "up", "eye"):
            np.testing.assert_allclose(getattr(r, f).numpy(), np.asarray(getattr(jr, f)), rtol=1e-6, atol=1e-6)
    assert np.degrees(np.arcsin(float(camera.rotate_camera(cam, 0.0, 3.0).direction[1]))) == pytest.approx(80.0,
                                                                                                           abs=1e-4)


# ---- mathx and the test images


def test_mathx_matches_jax():
    rng = np.random.default_rng(RNG_SEED)
    a, b, x = (rng.random(512, dtype=np.float32) * 20 - 10 for _ in range(3))
    u1, u2 = rng.random(512, dtype=np.float32), rng.random(512, dtype=np.float32)
    t = torch.from_numpy
    pairs = [
        (mathx.step(0.5, t(x)), jax_mathx.step(0.5, x)),
        (mathx.smoothstep(-2.0, 3.0, t(x)), jax_mathx.smoothstep(-2.0, 3.0, x)),
        (mathx.angle_distance(t(a), t(b)), jax_mathx.angle_distance(a, b)),
        (mathx.near_zero(t(np.stack([a, b * 0, x], -1) * 1e-9)), jax_mathx.near_zero(np.stack([a, b * 0, x], -1) * 1e-9)),
        (mathx.sample_unit_disk(t(u1), t(u2)), jax_mathx.sample_unit_disk(u1, u2)),
        (mathx.defocus_disk_sample(t(np.ones((512, 3), np.float32)), t(np.array([1.0, 0, 0], np.float32)),
                                   t(np.array([0, 0.5, 0], np.float32)), t(u1), t(u2)),
         jax_mathx.defocus_disk_sample(np.ones((512, 3), np.float32), np.array([1.0, 0, 0], np.float32),
                                       np.array([0, 0.5, 0], np.float32), u1, u2)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy().astype(np.float32), np.asarray(want).astype(np.float32), rtol=1e-5,
                                   atol=1e-5)
    assert mathx.degrees_to_rads(180.0) == jax_mathx.degrees_to_rads(180.0)


@pytest.mark.parametrize("name", ["mandelbrot_image", "kleinian_image"])
def test_test_images_match_jax(name):
    got = getattr(testimages, name)(40, 30)
    want = np.asarray(getattr(jax_testimages, name)(40, 30))
    assert got.shape == (30, 40, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---- the Renderer's controls, checkpoints and resume


def _renderer(target_spp: int):
    scene, cam = sphere_scene(depth=3)
    return Renderer(scene=scene, camera=cam, width=16, height=12, target_spp=target_spp, n_bounces=2)


def test_renderer_controls():
    r = _renderer(3)
    fb = r.render(passes=2)
    assert r.spp == 2 and fb is r.framebuffer
    r.render()
    assert r.spp == 3 and not r.step()
    r.set_target_spp(5)
    assert r.render() is r.framebuffer and r.spp == 5
    _, cam = sphere_scene(depth=3)
    r.set_camera(camera.move_camera(cam, forward=1.0))
    assert r.spp == 0 and r.counter == 0 and float(r.framebuffer.abs().sum()) == 0.0


def test_render_checkpoint_resume_is_bit_equal(tmp_path):
    """Checkpoint at 4 spp, resume to 8 in a new Renderer: the frame equals
    an uninterrupted 8-spp render's bit for bit; the extra payload comes
    back; a checkpoint of another resolution is refused."""
    r1 = _renderer(4)
    r1.render()
    ck = str(tmp_path / "ck.npz")
    save_render_checkpoint(ck, r1, extra={"note": np.arange(3), "nested": {"x": np.ones(2)}})
    r2 = _renderer(8)
    extra = load_render_checkpoint(ck, r2)
    np.testing.assert_array_equal(extra["note"], np.arange(3))
    np.testing.assert_array_equal(extra["nested"]["x"], np.ones(2))
    assert r2.spp == 4 and r2.target_spp == 8 and torch.equal(r2.framebuffer, r1.framebuffer)
    r2.render()
    ref = _renderer(8)
    ref.render()
    assert r2.spp == ref.spp == 8 and r2.counter == ref.counter
    assert torch.equal(r2.framebuffer, ref.framebuffer)
    scene, cam = sphere_scene(depth=3)
    with pytest.raises(ValueError, match="resolution"):
        load_render_checkpoint(ck, Renderer(scene=scene, camera=cam, width=8, height=12))


def test_cli_checkpoint_resume_is_bit_equal(tmp_path):
    common = ["--scene", "sphere", "--depth", "3", "--width", "16", "--height", "12", "--bounces", "2",
              "--device", "cpu"]
    ck = str(tmp_path / "ck.npz")
    main(["render", *common, "--spp", "4", "--checkpoint", ck, "-o", str(tmp_path / "a.ppm")])
    args = build_parser().parse_args(["render", *common, "--spp", "8", "--resume", ck, "-o", str(tmp_path / "b.ppm")])
    resumed = args.fn(args)
    args = build_parser().parse_args(["render", *common, "--spp", "8", "-o", str(tmp_path / "c.ppm")])
    whole = args.fn(args)
    assert resumed.spp == whole.spp == 8 and torch.equal(resumed.framebuffer, whole.framebuffer)
    assert (tmp_path / "b.ppm").read_bytes() == (tmp_path / "c.ppm").read_bytes()
