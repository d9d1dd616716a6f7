"""Block models against the JAX package: the accepting traversals with
models (kernel K2q's twins on the CPU) against JAX ``traverse`` with
``make_accept_fn``, ``record_surfaces`` and the stateful shadow walk, then
``resolve_hit`` and ``trace_paths``, on ``plant_scene(3)`` and on a 4^3
scene after ``test_blockmodels.py``: a stone floor, a cross plant, a grass
block with per-face materials and a half-height slab.

Gates: hit, leaf value, face, material and record rows (count, mats, face)
exact; t, uv, normal and the record's uu / vv / ts within 1e-4; frames
under the integrator gate (rtol and atol 2e-3 per lane, at most 2 bad
lanes).  Scenes and rays are made with numpy from a seed and handed to
both packages; JAX references are computed once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.diff.soft import record_surfaces as jax_record_surfaces
from octree_pathtracing_tpu.models import air as jax_air
from octree_pathtracing_tpu.models import make_material_table as jax_material_table
from octree_pathtracing_tpu.models import make_scene as jax_make_scene
from octree_pathtracing_tpu.models import plant_scene as jax_plant_scene
from octree_pathtracing_tpu.models.blockmodels import ModelBuilder as JaxModelBuilder
from octree_pathtracing_tpu.models.camera import pixel_grid_rays as jax_pixel_grid_rays
from octree_pathtracing_tpu.models.emitters import leaf_emissive_material as jax_leaf_emissive_material
from octree_pathtracing_tpu.octree import build_from_dense as jax_build_from_dense
from octree_pathtracing_tpu.ops.texture import build_atlas as jax_build_atlas
from octree_pathtracing_tpu.ops.traversal import traverse as jax_traverse
from octree_pathtracing_tpu.render import draw_uniforms as jax_draw_uniforms
from octree_pathtracing_tpu.render import trace_paths as jax_trace_paths
from octree_pathtracing_tpu.render.hit import make_accept_fn, make_shadow_accept_fn, shadow_state_init
from octree_pathtracing_tpu.render.hit import resolve_hit as jax_resolve_hit
from octree_pathtracing_tpu.render.pathtracer import _trace_stateful
from octree_pathtracing_tpu_torch.diff.soft import record_surfaces
from octree_pathtracing_tpu_torch.models import air, make_material_table, make_scene, plant_scene
from octree_pathtracing_tpu_torch.models.blockmodels import ModelBuilder, cross_plant_quads, slab_quads
from octree_pathtracing_tpu_torch.models.convert import scene_from_jax_arrays
from octree_pathtracing_tpu_torch.models.emitters import leaf_emissive_material
from octree_pathtracing_tpu_torch.octree import build_from_dense
from octree_pathtracing_tpu_torch.ops.geometry import QuadSoA
from octree_pathtracing_tpu_torch.ops.texture import build_atlas
from octree_pathtracing_tpu_torch.ops.traversal import traverse_alpha, traverse_shadow
from octree_pathtracing_tpu_torch.render import trace_paths_census
from octree_pathtracing_tpu_torch.render.hit import accept_tables, resolve_hit

MAX_DIST = 1024.0
MODEL_FIELDS = ("leaf_model", "flags", "face_material", "quad_start", "quad_count")


def _solid(rgb):
    img = np.zeros((16, 16, 4), np.uint8)
    img[..., :3] = rgb
    img[..., 3] = 255
    return img


def _cube_grid():
    """4^3: stone floor (leaf 1), a cross plant on it (2), a grass block with
    per-face materials (3) and a bottom slab (4)."""
    grid = np.zeros((4, 4, 4), np.uint32)
    grid[:, 0, :] = 1
    grid[1, 1, 1] = 2
    grid[3, 1, 3] = 3
    grid[3, 1, 0] = 4
    return grid


def _cube_models(builder):
    mb = builder()
    mb.add_simple(0)
    mb.add_simple(1)
    mb.add_quad_model(cross_plant_quads(material=2))
    mb.add_simple([1, 1, 1, 3, 1, 1])  # grass: the top face (id 3) is material 3
    mb.add_quad_model(slab_quads(material=1, height=0.5))
    return mb.build([0, 1, 2, 3, 4])


_CUBE_TEXTURES = [_solid((255, 0, 255)), _solid((128, 128, 128)), _solid((40, 200, 40)), _solid((60, 160, 60))]
_CUBE_MATERIALS = [dict(texture_index=1), dict(texture_index=2), dict(texture_index=3)]


def _cube_rays(rng):
    """The named rays of test_blockmodels.py (corner of the plant, its
    centre, the grass block from above and from the side, the slab from
    above, above its top and at its side), then random rays into the cube."""
    named = np.array([
        [1.02, 1.98, -2.0, 0.0, -0.28, 1.0],
        [1.5, 1.5, -2.0, 0.0, 0.0, 1.0],
        [3.5, 3.9, 3.5, 0.0, -1.0, 0.0],
        [-2.0, 1.5, 3.5, 1.0, 0.0, 0.0],
        [3.5, 3.9, 0.5, 0.0, -1.0, 0.0],
        [-2.0, 1.75, 0.5, 1.0, 0.0, 0.0],
        [-2.0, 1.25, 0.5, 1.0, 0.0, 0.0],
    ], np.float32)
    o = rng.uniform(-3, 7, (249, 3))
    d = rng.uniform(0.2, 3.8, (249, 3)) - o
    origins = np.concatenate([named[:, :3], o]).astype(np.float32)
    dirs = np.concatenate([named[:, 3:], d]).astype(np.float32)
    return origins, (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def cases():
    jplant, cam = jax_plant_scene(depth=3)
    o, d = jax_pixel_grid_rays(cam, 16, 16)
    jcube = jax_make_scene(jax_build_from_dense(_cube_grid()), jax_material_table([jax_air()] + _CUBE_MATERIALS),
                           jax_build_atlas(_CUBE_TEXTURES), models=_cube_models(JaxModelBuilder))
    co, cd = _cube_rays(np.random.default_rng(3))
    return {"plant3": (jplant, np.array(o), np.array(d)), "cube4": (jcube, co, cd)}


def _jax_hits(jscene, o, d):
    tree = jscene.octree
    o, d = jnp.asarray(o), jnp.asarray(d)
    res = jax_traverse(tree.child_mask, tree.child_data, tree.root, tree.scale(), o, d, max_dst=MAX_DIST,
                       accept_fn=make_accept_fn(jscene, o, d), depth=tree.depth)
    return res, jax_resolve_hit(jscene, o, d, res)


def _port_hits(scene, o, d):
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    res = traverse_alpha(scene.nodes, scene.root, scene.depth, scene.octree_scale, o, d, accept_tables(scene),
                         MAX_DIST)
    return res, resolve_hit(scene, o, d, res)


@pytest.fixture(scope="module")
def hits(cases):
    return {name: (_jax_hits(j, o, d), _port_hits(scene_from_jax_arrays(j), o, d)) for name, (j, o, d) in cases.items()}


@pytest.mark.parametrize("name", ["plant3", "cube4"])
def test_alpha_walk_and_resolve_hit_match_jax(hits, name):
    (jres, jsurf), (res, surf) = hits[name]
    hit = np.asarray(jres.hit)
    np.testing.assert_array_equal(res.hit.numpy(), hit)
    np.testing.assert_array_equal(res.face_id.numpy(), np.asarray(jres.face_id))
    np.testing.assert_array_equal(res.leaf_value.numpy(), np.asarray(jres.leaf_value).astype(np.int64))
    np.testing.assert_allclose(res.t.numpy()[hit], np.asarray(jres.t)[hit], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.uv.numpy()[hit], np.asarray(jres.uv)[hit], atol=1e-4)
    mat, uv, n, t = (x.numpy()[hit] for x in surf)
    jmat, juv, jn, jt = (np.asarray(x)[hit] for x in jsurf)
    np.testing.assert_array_equal(mat, jmat)
    np.testing.assert_allclose(uv, juv, atol=1e-4)
    np.testing.assert_allclose(n, jn, atol=1e-4)
    np.testing.assert_allclose(t, jt, rtol=1e-4, atol=1e-4)
    quad = res.quad.found.numpy()
    assert quad.any() and (hit & ~quad).any() and not (quad & ~hit).any()


def test_named_rays_on_the_cube(hits):
    """The cases of test_blockmodels.py, through the port: the ray past the
    plant's corner reaches the floor; the centre ray hits a plant quad
    (horizontal normal, t in (3, 4)); the grass block shows material 3 on
    top and 1 on its side; the slab is hit on its top at half height and at
    its side below it, and a ray above it passes."""
    _, (res, (mat, uv, n, t)) = hits["cube4"]
    assert res.hit[:7].tolist() == [True, True, True, True, True, False, True]
    assert mat[:5].tolist() == [1, 2, 3, 1, 1] and int(mat[6]) == 1
    assert 3.0 < float(t[1]) < 4.0 and abs(float(n[1, 1])) < 1e-5
    torch.testing.assert_close(t[4], torch.tensor(2.4), rtol=1e-5, atol=1e-5)  # y 3.9 down to 1.5
    torch.testing.assert_close(n[4], torch.tensor([0.0, 1.0, 0.0]))
    torch.testing.assert_close(t[6], torch.tensor(5.0), rtol=1e-5, atol=1e-5)  # x -2 to the slab's side at 3
    assert res.quad.found[:7].tolist() == [False, True, False, False, True, False, True]


@pytest.mark.parametrize("name", ["plant3", "cube4"])
def test_record_surfaces_match_jax(cases, name):
    jscene, o, d = cases[name]
    want = jax.tree.map(np.asarray, jax_record_surfaces(jscene, jnp.asarray(o), jnp.asarray(d)))
    rec = record_surfaces(scene_from_jax_arrays(jscene), torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(rec.count.numpy(), want["count"])
    assert (rec.count.numpy() >= 2).any()
    live = np.arange(4)[:, None] < want["count"][None, :]
    for f in ("mats", "face"):
        np.testing.assert_array_equal(getattr(rec, f).numpy()[live], want[f][live], err_msg=f)
    for f in ("uu", "vv"):
        np.testing.assert_allclose(getattr(rec, f).numpy()[live], want[f][live], atol=1e-4, err_msg=f)


@pytest.mark.parametrize("name", ["plant3", "cube4"])
def test_shadow_walk_matches_jax(cases, hits, name):
    """The stateful shadow walk (strict, t recorded) from the primaries' hit
    points in random directions of their hemisphere, and from above."""
    jscene, o, d = cases[name]
    _, (res, (_, _, n, t)) = hits[name]
    rng = np.random.default_rng(8)
    b = o.shape[0]
    hp = np.where(res.hit.numpy()[:, None], o + d * np.where(res.hit.numpy(), t.numpy(), 0.0)[:, None], o)
    rnd = rng.standard_normal((b, 3)).astype(np.float32)
    rnd /= np.linalg.norm(rnd, axis=-1, keepdims=True)
    rnd = np.where((rnd * n.numpy()).sum(-1, keepdims=True) < 0, -rnd, rnd)
    top = np.stack([rng.uniform(0, 4, b), np.full(b, 3.9), rng.uniform(0, 4, b)], -1)
    down = np.tile(np.array([[0.0, -1.0, 0.0]]), (b, 1)) + rng.normal(0, 0.2, (b, 3))
    down /= np.linalg.norm(down, axis=-1, keepdims=True)
    so = np.concatenate([hp + rnd * 1e-4, top]).astype(np.float32)
    sd = np.concatenate([rnd, down]).astype(np.float32)
    active = np.concatenate([res.hit.numpy(), rng.random(b) < 0.9])
    cur_mat = rng.integers(0, 3, 2 * b).astype(np.int32)

    def builder(s, oo, dd):
        return make_shadow_accept_fn(s, oo, dd, True)

    jres, jst = _trace_stateful(jscene, jnp.asarray(so), jnp.asarray(sd), builder,
                                shadow_state_init(jnp.asarray(cur_mat), 4, record_t=True), active=jnp.asarray(active))
    jst = jax.tree.map(np.asarray, jst)
    scene = scene_from_jax_arrays(jscene)
    got, st = traverse_shadow(scene.nodes, scene.root, scene.depth, scene.octree_scale, torch.from_numpy(so),
                              torch.from_numpy(sd), accept_tables(scene), torch.from_numpy(cur_mat), True, True,
                              MAX_DIST, torch.from_numpy(active))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(jres.hit))
    np.testing.assert_array_equal(got.leaf_value.numpy(), np.asarray(jres.leaf_value).astype(np.int64))
    np.testing.assert_array_equal(st.count.numpy(), jst["count"])
    np.testing.assert_array_equal(st.cm.numpy(), jst["cm"])
    assert (st.count.numpy() >= 1).sum() > 10
    live = np.arange(4)[:, None] < jst["count"][None, :]
    np.testing.assert_array_equal(st.mats.numpy()[live], jst["mats"][live])
    for f in ("uu", "vv", "ts"):
        np.testing.assert_allclose(getattr(st, f).numpy()[live], jst[f][live], rtol=1e-4, atol=1e-4, err_msg=f)
    np.testing.assert_allclose(st.w.numpy(), jst["w"], atol=1e-4)


def test_trace_paths_matches_jax_per_lane(cases):
    """The plant field under its own HIGH_QUALITY sun: quad-model bounces
    and shadow walks, per lane."""
    jscene, o, d = cases["plant3"]
    u = np.array(jax_draw_uniforms(jax.random.PRNGKey(0), o.shape[0], n_bounces=2))
    want = np.asarray(jax.jit(lambda o, d, u: jax_trace_paths(jscene, o, d, u, tiles=1))(o, d, jnp.asarray(u)))
    got, live = trace_paths_census(scene_from_jax_arrays(jscene), torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(u))
    got = got.numpy()
    assert np.isfinite(got).all() and got.mean() > 0.01 and live[1] > 0
    bad = ~np.all(np.isclose(got, want, rtol=2e-3, atol=2e-3), axis=-1)
    assert bad.sum() <= 2, (bad.sum(), np.flatnonzero(bad)[:5])


def _assert_models_equal(got, want, exact_quads: bool):
    for f in MODEL_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    for f in QuadSoA._fields:
        g, w = getattr(got.quads, f).numpy(), np.asarray(getattr(want.quads, f))
        if exact_quads or f == "material_id":
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=f)


def test_scene_tables_match_jax(cases):
    """The port's builders give the JAX scenes' tables and flags; carried
    over from JAX they are the same numbers."""
    jplant, jcube = cases["plant3"][0], cases["cube4"][0]
    plant, _ = plant_scene(depth=3)
    cube = make_scene(build_from_dense(_cube_grid()), make_material_table([air()] + _CUBE_MATERIALS),
                      build_atlas(_CUBE_TEXTURES), models=_cube_models(ModelBuilder))
    for port, jscene in ((plant, jplant), (cube, jcube)):
        carried = scene_from_jax_arrays(jscene)
        _assert_models_equal(port.models, jscene.models, exact_quads=False)
        _assert_models_equal(carried.models, jscene.models, exact_quads=True)
        for scene in (port, carried):
            np.testing.assert_array_equal(scene.nodes.numpy(), carried.nodes.numpy())
            assert (scene.has_quad_models, scene.opaque_only, scene.shadow_binary) == (
                jscene.has_quad_models, jscene.opaque_only, jscene.shadow_binary)
            assert dataclasses.asdict(scene.sun_sampling) == dataclasses.asdict(jscene.sun_sampling)
        assert carried.prims is None


def test_emissive_materials_of_models_match_jax(cases):
    """A model leaf's emitter material is its brightest face material."""
    jcube = cases["cube4"][0]
    emittance = np.array([0.0, 0.0, 5.0, 2.0], np.float32)
    jmats = dataclasses.replace(jcube.materials, emittance=jnp.asarray(emittance))
    values = np.array([0, 1, 2, 3, 4, 7], np.int64)
    want = jax_leaf_emissive_material(values, jcube.leaf_material, jmats, jcube.models)
    got = leaf_emissive_material(values, np.asarray(jcube.leaf_material), emittance,
                                 scene_from_jax_arrays(jcube).models)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [-1, -1, 2, 3, -1, -1]
