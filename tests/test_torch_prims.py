"""Analytic primitives (``models/prims.py``, kernel K7's twin on the CPU)
against the JAX package: ``intersect_prims`` on ``analytic_sphere_scene(4)``
at 16x16 primaries and on random rays, the backface cull, the scene tables
(built by the port and carried over from JAX), and ``trace_paths`` per lane
under IMPORTANCE and HIGH_QUALITY (sun shadow rays see the primitives).

Gates: hit and material exact; t within rtol 1e-5; uv and normal within
atol 1e-4; the integrator gate for frames (rtol and atol 2e-3 per lane, at
most 2 bad lanes).  Inputs are made with numpy from a seed; JAX references
are computed once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.models import analytic_sphere_scene as jax_analytic_scene
from octree_pathtracing_tpu.models.camera import pixel_grid_rays as jax_pixel_grid_rays
from octree_pathtracing_tpu.models.prims import intersect_prims as jax_intersect_prims
from octree_pathtracing_tpu.models.sun import SunSampling as JaxSunSampling
from octree_pathtracing_tpu.render import draw_uniforms as jax_draw_uniforms
from octree_pathtracing_tpu.render import trace_paths as jax_trace_paths
from octree_pathtracing_tpu_torch.models import analytic_sphere_scene
from octree_pathtracing_tpu_torch.models.convert import scene_from_jax_arrays
from octree_pathtracing_tpu_torch.models.prims import intersect_prims, intersect_prims_reference, make_primitives
from octree_pathtracing_tpu_torch.ops.geometry import QuadSoA
from octree_pathtracing_tpu_torch.render import trace_paths_census

W, H = 16, 16
MAX_DIST = 1024.0


@pytest.fixture(scope="module")
def case():
    jscene, cam = jax_analytic_scene(depth=4)
    o, d = jax_pixel_grid_rays(cam, W, H)
    rng = np.random.default_rng(4)
    ro = rng.uniform(-4, 20, (W * H, 3)).astype(np.float32)  # some inside the sphere, some behind the quad
    rd = rng.standard_normal((W * H, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    origins = np.concatenate([np.array(o), ro])
    dirs = np.concatenate([np.array(d), rd.astype(np.float32)])
    return jscene, cam, origins, dirs


def _compare(got, want, n_hits_min):
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    h = want[0]
    assert h.sum() >= n_hits_min and not h.all()
    np.testing.assert_allclose(got[1][h], want[1][h], rtol=1e-5)
    assert np.isinf(got[1][~h]).all()
    np.testing.assert_allclose(got[3][h], want[3][h], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[4][h], want[4][h], rtol=0, atol=1e-4)


@pytest.mark.parametrize("t_max", [MAX_DIST, 14.0])
def test_intersect_prims_matches_jax(case, t_max):
    jscene, _, origins, dirs = case
    want = jax.jit(lambda o, d: jax_intersect_prims(jscene.prims, o, d, t_max))(origins, dirs)
    scene = scene_from_jax_arrays(jscene)
    before = intersect_prims.launches
    got = intersect_prims(scene.prims, torch.from_numpy(origins), torch.from_numpy(dirs), t_max)
    assert intersect_prims.launches == before  # the CPU runs the twin
    _compare(got, want, 15)
    if t_max == MAX_DIST:  # the sphere and the quad are both hit
        assert set(got[2][got[0]].tolist()) == {2, 3}


def test_quad_backface_is_culled():
    prims = make_primitives(quads=(np.array([[0.0, 0.0, 2.0]], np.float32), np.array([[0.0, 1.0, 0.0]], np.float32),
                                   np.array([[1.0, 0.0, 0.0]], np.float32), np.array([1], np.int32)))
    o = torch.tensor([[0.5, 0.5, 0.0], [0.5, 0.5, 4.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    hit, t, mat, uv, n = intersect_prims(prims, o, d, MAX_DIST)
    assert hit.tolist() == [True, False]
    torch.testing.assert_close(t[0], torch.tensor(2.0), rtol=1e-5, atol=0)
    assert int(mat[0]) == 1 and torch.isinf(t[1])


def test_sphere_in_front_of_and_beside_the_ray():
    prims = make_primitives(spheres=[((0.0, 0.0, 5.0), 1.0, 7)])
    o = torch.tensor([[0.0, 0.0, 0.0], [0.0, 3.0, 0.0], [0.5, 0.2, -1.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    hit, t, mat, _, _ = intersect_prims_reference(prims, o, d, MAX_DIST)
    assert hit.tolist() == [True, False, True] and int(mat[0]) == 7
    torch.testing.assert_close(t[0], torch.tensor(4.0), rtol=1e-5, atol=0)


def test_scene_tables_match_jax(case):
    """The port's own analytic scene and the one carried over from JAX hold
    the same primitive tables (and flags) as the JAX scene."""
    jscene = case[0]
    built, _ = analytic_sphere_scene(depth=4)
    carried = scene_from_jax_arrays(jscene)
    jp = jscene.prims
    for scene in (built, carried):
        p = scene.prims
        np.testing.assert_array_equal(p.sphere_center.numpy(), np.asarray(jp.sphere_center))
        np.testing.assert_array_equal(p.sphere_radius.numpy(), np.asarray(jp.sphere_radius))
        np.testing.assert_array_equal(p.sphere_mat.numpy(), np.asarray(jp.sphere_mat))
        for f in QuadSoA._fields:
            np.testing.assert_allclose(getattr(p.quads, f).numpy(), np.asarray(getattr(jp.quads, f)),
                                       rtol=1e-6, atol=1e-7, err_msg=f)
        assert (scene.opaque_only, scene.shadow_binary, scene.has_quad_models) == (
            jscene.opaque_only, jscene.shadow_binary, jscene.has_quad_models)
    for f in QuadSoA._fields:  # carried over bit for bit
        np.testing.assert_array_equal(getattr(carried.prims.quads, f).numpy(), np.asarray(getattr(jp.quads, f)))


@pytest.mark.parametrize("sun", ["importance", "high_quality"])
def test_trace_paths_matches_jax_per_lane(case, sun):
    jscene, cam, _, _ = case
    jscene = dataclasses.replace(jscene, sun_sampling=getattr(JaxSunSampling, sun)())
    o, d = jax_pixel_grid_rays(cam, W, H)
    u = np.array(jax_draw_uniforms(jax.random.PRNGKey(1 + (sun == "high_quality")), W * H, n_bounces=3))
    want = np.asarray(jax.jit(lambda o, d, u: jax_trace_paths(jscene, o, d, u, tiles=1))(o, d, jnp.asarray(u)))
    before = intersect_prims.launches
    got, live = trace_paths_census(scene_from_jax_arrays(jscene), torch.from_numpy(np.array(o)),
                                   torch.from_numpy(np.array(d)), torch.from_numpy(u))
    assert intersect_prims.launches == before
    got = got.numpy()
    assert np.isfinite(got).all() and got.mean() > 0.01
    bad = ~np.all(np.isclose(got, want, rtol=2e-3, atol=2e-3), axis=-1)
    assert bad.sum() <= 2, (bad.sum(), np.flatnonzero(bad)[:5])
    assert live[1] > 0
