"""Integrator parity: the port's wavefront path tracer against the JAX
``trace_paths`` per lane (with and without sun and emitter NEE), against
the committed golden frames, and against itself (branched vs plain
estimator); the progressive renderer; refusals.

Uniform blocks are drawn with ``jax.random`` and handed to both packages
(threefry and Philox differ by design).  On the CPU the port's traversal is
its plain-torch twin.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.models import cutout_chunk_scene as jax_cutout_scene
from octree_pathtracing_tpu.models import emissive_room_scene as jax_room_scene
from octree_pathtracing_tpu.models import minecraft_chunk_scene as jax_chunk_scene
from octree_pathtracing_tpu.models.camera import pixel_grid_rays as jax_pixel_grid_rays
from octree_pathtracing_tpu.models.sun import SunSampling as JaxSunSampling
from octree_pathtracing_tpu.render import draw_uniforms as jax_draw_uniforms
from octree_pathtracing_tpu.render import trace_paths as jax_trace_paths
from octree_pathtracing_tpu_torch.models import (
    cornell_scene,
    cutout_chunk_scene,
    emissive_room_scene,
    minecraft_chunk_scene,
    scattered_lights_scene,
    sphere_scene,
)
from octree_pathtracing_tpu_torch.models.blockmodels import ModelBuilder, cross_plant_quads
from octree_pathtracing_tpu_torch.models.camera import pixel_grid_rays
from octree_pathtracing_tpu_torch.models.prims import make_primitives
from octree_pathtracing_tpu_torch.models.convert import scene_from_jax_arrays
from octree_pathtracing_tpu_torch.models.scene import make_scene
from octree_pathtracing_tpu_torch.octree import build_from_dense
from octree_pathtracing_tpu_torch.models.sun import SunSampling
from octree_pathtracing_tpu_torch.render import (
    Renderer,
    trace_paths,
    trace_paths_branched,
    trace_paths_census,
)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _uniforms(seed, n_lanes, n_bounces):
    return np.array(jax_draw_uniforms(jax.random.PRNGKey(seed), n_lanes, n_bounces=n_bounces))


def _per_lane_against_jax(jscene, cam, n_bounces, seed):
    """The port's ``trace_paths_census`` and JAX ``trace_paths`` on one
    16x12 lane batch and one JAX-drawn block; asserts the integrator gate
    (test_pathtracer.py): rtol and atol 2e-3 per lane, at most 2 bad lanes.
    Returns (radiance, live)."""
    o, d = jax_pixel_grid_rays(cam, 16, 12)
    u = _uniforms(seed, o.shape[0], n_bounces)
    want = np.asarray(
        jax.jit(lambda o, d, u: jax_trace_paths(jscene, o, d, u, tiles=1))(o, d, jnp.asarray(u))
    )
    got, live = trace_paths_census(
        scene_from_jax_arrays(jscene), torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)),
        torch.from_numpy(u),
    )
    got = got.numpy()
    assert np.isfinite(got).all() and got.mean() > 0.01
    bad = ~np.all(np.isclose(got, want, rtol=2e-3, atol=2e-3), axis=-1)
    assert bad.sum() <= 2, (bad.sum(), np.flatnonzero(bad)[:5])
    return got, live.tolist()


def test_trace_paths_matches_jax_per_lane():
    jscene, cam = jax_chunk_scene(depth=5)
    _, live = _per_lane_against_jax(jscene, cam, 5, 0)
    assert live[0] == 16 * 12 and all(a >= b for a, b in zip(live, live[1:])) and live[-1] > 0


def _high_quality(build):
    def f():
        jscene, cam = build(depth=4)
        return dataclasses.replace(jscene, sun_sampling=JaxSunSampling.high_quality()), cam

    return f


def _room(sampling):
    def f():
        jscene, cam = jax_room_scene(depth=3)
        return dataclasses.replace(jscene, emitter_sampling=sampling), cam

    return f


@pytest.mark.parametrize(
    "build,n_bounces,seed",
    [
        pytest.param(_high_quality(jax_chunk_scene), 5, 0, id="terrain4_high_quality"),
        pytest.param(_high_quality(jax_cutout_scene), 5, 1, id="cutout4_high_quality"),
        pytest.param(_room("one"), 3, 2, id="room3_one"),
        pytest.param(_room("one_block"), 3, 2, id="room3_one_block"),
        pytest.param(_room("all"), 3, 2, id="room3_all"),
    ],
)
def test_light_sampling_matches_jax_per_lane(build, n_bounces, seed):
    """Sun NEE (HIGH_QUALITY: the binary walk on the terrain, K3s on the
    cutout) and emitter NEE (ONE, ONE_BLOCK, ALL) against JAX, per lane."""
    jscene, cam = build()
    _per_lane_against_jax(jscene, cam, n_bounces, seed)


def _tonemap(x):
    return np.clip(x, 0.0, 1.0) ** (1.0 / 2.2)


def _port_high_quality(built):
    scene, cam = built
    return dataclasses.replace(scene, sun_sampling=SunSampling.high_quality()), cam


@pytest.mark.parametrize(
    "name,build,w,h,spp,n_bounces,seed",
    [
        ("config1_sphere", lambda: sphere_scene(depth=5), 48, 36, 2, 2, 101),
        ("config2_cornell", lambda: cornell_scene(depth=5), 48, 36, 2, 4, 202),
        ("config3_chunk_nee", lambda: _port_high_quality(minecraft_chunk_scene(depth=5)), 48, 36, 2, 3, 303),
        ("config3b_cutout", lambda: _port_high_quality(cutout_chunk_scene(depth=4)), 40, 30, 2, 3, 404),
        ("config4_emitter_one", lambda: emissive_room_scene(depth=4), 32, 24, 2, 2, 505),
        ("config4b_scattered", lambda: scattered_lights_scene(depth=5, n_lights=60), 32, 24, 2, 2, 606),
    ],
)
def test_golden_frame_through_the_port(name, build, w, h, spp, n_bounces, seed):
    """test_goldens.render_config's scene, size, seeds and bounce count,
    rendered by the port; test_goldens.py's gate (5e-3 on 99% of pixels,
    mean 5e-4)."""
    scene, cam = build()
    origins, dirs = pixel_grid_rays(cam, w, h)
    acc = np.zeros((w * h, 3), np.float64)
    for k in range(spp):
        u = torch.from_numpy(_uniforms(seed + k, w * h, n_bounces))
        acc += trace_paths(scene, origins, dirs, u).numpy()
    got = (acc / spp).reshape(h, w, 3).astype(np.float32)
    want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["radiance"]
    diff = np.abs(_tonemap(got) - _tonemap(want))
    assert (diff <= 5e-3).mean() >= 0.99 and diff.mean() <= 5e-4, (diff.max(), diff.mean())


def test_branched_equals_mean_of_plain_paths():
    scene, cam = minecraft_chunk_scene(depth=4)
    origins, dirs = pixel_grid_rays(cam, 12, 8)
    b, k = origins.shape[0], 3
    u = torch.from_numpy(_uniforms(9, b * k, 4).reshape(b, k, 4, -1))
    got = trace_paths_branched(scene, origins, dirs, u)
    want = torch.stack([trace_paths(scene, origins, dirs, u[:, i]) for i in range(k)]).mean(0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert got.mean() > 0.01


def test_renderer_reaches_target_spp():
    scene, cam = minecraft_chunk_scene(depth=4)
    r = Renderer(scene=scene, camera=cam, width=16, height=12, target_spp=12, branch_count=10, seed=3)
    passes = 0
    while r.step():
        passes += 1
    assert r.spp == 12 and passes == 6  # 1, 1, 1, 1, then 6 and 2 branched samples
    img = r.framebuffer
    assert img.shape == (12, 16, 3) and torch.isfinite(img).all() and img.mean() > 0.01
    assert r.get_image().dtype == np.uint8


def test_refused_paths_raise():
    """The brick layout stays refused; block models, primitives, sun
    strategies with shadow rays and emitter sampling run (through the
    port's branched estimator too)."""
    scene, cam = minecraft_chunk_scene(depth=3)
    o, d = pixel_grid_rays(cam, 4, 4)
    u = torch.rand((16, 2, 21))
    for ok in (
        dataclasses.replace(scene, sun_sampling=SunSampling.high_quality()),
        dataclasses.replace(scene, sun_sampling=SunSampling.fast()),
        make_scene(build_from_dense(np.ones((4, 4, 4), np.uint32)), scene.materials, scene.atlas,
                   emitter_sampling="one"),
    ):
        assert torch.isfinite(trace_paths(ok, o, d, u)).all()
        assert torch.isfinite(trace_paths_branched(ok, o, d, u[:, None])).all()
    # alpha-tested scenes run the in-loop accept (K2); on an all-opaque
    # atlas it accepts every candidate, so the frame is K1's
    alpha = dataclasses.replace(scene, opaque_only=False)
    torch.testing.assert_close(trace_paths(alpha, o, d, u), trace_paths(scene, o, d, u), rtol=0, atol=0)
    from octree_pathtracing_tpu.octree import build_from_dense as jax_build_from_dense

    tree = jax_build_from_dense(np.ones((4, 4, 4), np.uint32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_scene(tree, scene.materials, scene.atlas, brick=True)
    # block models and analytic primitives are accepted and traced
    mb = ModelBuilder()
    mb.add_simple(1)
    mb.add_quad_model(cross_plant_quads(material=2))
    models = mb.build([0, 1, 0, 1, 0, 1, 0, 1, 0, 1])
    prims = make_primitives(spheres=[((2.0, 6.0, 2.0), 1.5, 3)])
    for kw in (dict(models=models), dict(prims=prims), dict(models=models, prims=prims)):
        built = make_scene(tree, scene.materials, scene.atlas, **kw)
        assert built.has_quad_models == ("models" in kw)
        assert built.opaque_only == (scene.opaque_only and "models" not in kw)
        assert torch.isfinite(trace_paths(built, o, d, u)).all()
        assert torch.isfinite(trace_paths_branched(built, o, d, u[:, None])).all()
    from octree_pathtracing_tpu.octree.brick import brickify

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_scene(brickify(build_from_dense(np.ones((8, 8, 8), np.uint32))), scene.materials, scene.atlas)
