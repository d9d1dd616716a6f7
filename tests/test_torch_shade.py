"""Kernel K4's twins against the JAX package: ``ops/shade.shade_reference``
against the JAX ``_shade`` (render/pathtracer.py, with no next-event
estimate on either side) and ``shade_backward_reference`` against
``jax.vjp`` of the same ``_shade``, on one bounce of each scene kind; then
``ShadeFunction``'s CPU route against torch autograd of the twin, and its
refusal of a gradient it does not compute.

Both packages shade the same state, the same ``jax.random`` uniforms and
the same hits (the port's traversal twin, carried into a JAX
``HitResult``).  Forward gate, the integrator's (test_pathtracer.py):
integers and masks exact, floats within rtol and atol 2e-3, at most 2 bad
lanes.  Backward gate rtol 1e-5, atol 1e-7 (XLA and torch round sin, cos,
sqrt an ulp apart), over the lanes whose forward agrees.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.models import analytic_sphere_scene as jax_analytic_scene
from octree_pathtracing_tpu.models import cutout_chunk_scene as jax_cutout_scene
from octree_pathtracing_tpu.models import emissive_room_scene as jax_room_scene
from octree_pathtracing_tpu.models import minecraft_chunk_scene as jax_chunk_scene
from octree_pathtracing_tpu.models import plant_scene as jax_plant_scene
from octree_pathtracing_tpu.models.blockpalette import minecraft_scene_from_region as jax_scene_from_region
from octree_pathtracing_tpu.models.camera import pixel_grid_rays as jax_pixel_grid_rays
from octree_pathtracing_tpu.models.materials import gather_rows as jax_gather_rows
from octree_pathtracing_tpu.models.sun import SunSampling as JaxSunSampling
from octree_pathtracing_tpu.ops.texture import Atlas as JaxAtlas
from octree_pathtracing_tpu.ops.texture import sample_atlas as jax_sample_atlas
from octree_pathtracing_tpu.ops.traversal import HitResult as JaxHitResult
from octree_pathtracing_tpu.render import draw_uniforms as jax_draw_uniforms
from octree_pathtracing_tpu.render import pathtracer as jpt
from octree_pathtracing_tpu.render.hit import resolve_hit as jax_resolve_hit
from octree_pathtracing_tpu_torch.models import make_region_fixture
from octree_pathtracing_tpu_torch.models.convert import scene_from_jax_arrays
from octree_pathtracing_tpu_torch.ops import shade as tshade
from octree_pathtracing_tpu_torch.ops.texture import Atlas
from octree_pathtracing_tpu_torch.render import pathtracer as tpt

W = H = 16
FLOAT_KEYS = ("origin", "dir", "throughput", "radiance")
EXACT_KEYS = ("active", "specular", "cur_mat")


def _write_json(root, rel, obj):
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    with open(p, "w") as f:
        json.dump(obj, f)


def _write_png(root, rel, rgba, size):
    from PIL import Image

    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    img = np.zeros((size, size, 4), np.uint8)
    img[...] = rgba
    img[: size // 2, : size // 2, :3] //= 2  # a darker quarter: the texel picked matters
    Image.fromarray(img, "RGBA").save(p)


def _world_with_pack(tmp):
    """A 16^3 region section (stone floor and hill, a leaf canopy, a pool of
    water, a glass box) read with a resource pack whose stone is 16^2 and
    whose leaves are 32^2: an ``Atlas`` with per-layer sizes."""
    pack = os.path.join(tmp, "pack")
    faces = ("down", "up", "north", "south", "west", "east")
    _write_json(pack, "assets/minecraft/models/block/cube_all.json",
                {"elements": [{"from": [0, 0, 0], "to": [16, 16, 16],
                               "faces": {f: {"texture": "#all"} for f in faces}}]})
    for name, rgba, size in (("stone", (200, 120, 90, 255), 16), ("oak_leaves", (60, 140, 40, 200), 32)):
        _write_json(pack, f"assets/minecraft/models/block/{name}.json",
                    {"parent": "block/cube_all", "textures": {"all": f"block/{name}"}})
        _write_json(pack, f"assets/minecraft/blockstates/{name}.json", {"variants": {"": {"model": f"block/{name}"}}})
        _write_png(pack, f"assets/minecraft/textures/block/{name}.png", rgba, size)
    blocks = ["minecraft:air", "minecraft:stone", "minecraft:oak_leaves", "minecraft:water", "minecraft:glass"]
    g = np.zeros((16, 16, 16), np.uint16)  # [y, z, x]
    g[0:2] = 1
    g[2:5, 6:10, 6:10] = 1
    g[6:9, 3:8, 8:13] = 2
    g[2, 1:5, 1:5] = 3
    g[2:5, 11:14, 2:5] = 4
    path = os.path.join(tmp, "r.0.0.mca")
    with open(path, "wb") as f:
        f.write(make_region_fixture({(0, 0): {-4: (blocks, g.ravel())}}))
    return jax_scene_from_region(path, depth=4, pack_dir=pack)


def _importance(build):
    return lambda tmp: build(depth=4)


def _off(tmp):
    jscene, cam = jax_chunk_scene(depth=4)
    return dataclasses.replace(jscene, sun_sampling=JaxSunSampling.off()), cam


def _glossy(tmp):
    """The terrain with metal, rough and mirror-like specular materials."""
    jscene, cam = jax_chunk_scene(depth=4)
    m = jscene.materials
    k = np.arange(m.ior.shape[0])
    mats = dataclasses.replace(m, metalness=jnp.asarray(np.where(k % 3 == 1, 0.5, 0.0), jnp.float32),
                               specular=jnp.asarray(np.where(k % 3 == 2, 0.6, 0.0), jnp.float32),
                               roughness=jnp.asarray(np.where(k % 2 == 0, 0.3, 0.0), jnp.float32))
    return dataclasses.replace(jscene, materials=mats), cam


def _room(tmp):
    """Emission counts on the primary bounce only: emitter sampling is on,
    but with no emitter table neither package runs the NEE."""
    jscene, cam = jax_room_scene(depth=3)
    return dataclasses.replace(jscene, emitter_sampling="one", emitters=None), cam


# name -> (JAX scene builder, is_first, may_scatter)
CASES = {
    "terrain_importance": (_importance(jax_chunk_scene), False, True),
    "terrain_off": (_off, True, True),
    "terrain_glossy": (_glossy, False, True),
    "cutout": (_importance(jax_cutout_scene), False, True),
    "plant_field": (_importance(jax_plant_scene), False, True),
    "analytic": (_importance(jax_analytic_scene), True, True),
    "room_primary": (_room, True, True),
    "room_later_depth_cap": (_room, False, False),
    "world_pack": (_world_with_pack, False, True),
}


def _state(rng, o, d, n_mat):
    b = o.shape[0]
    return dict(
        origin=o.astype(np.float32), dir=d.astype(np.float32),
        throughput=rng.uniform(0.2, 1.0, (b, 3)).astype(np.float32),
        radiance=rng.uniform(0.0, 0.5, (b, 3)).astype(np.float32),
        active=rng.random(b) < 0.9, specular=rng.random(b) < 0.5,
        cur_mat=rng.integers(0, n_mat, b).astype(np.int32),
    )


def _jax_shade_fn(jscene, jst, u, jres, is_first, may_scatter):
    """(atlas texels, emittance, throughput, radiance) -> (the JAX _shade's
    state, the hit's albedo), for jax.vjp."""

    def fn(texels, emittance, throughput, radiance):
        atlas = dataclasses.replace(jscene.atlas, data=texels) if isinstance(jscene.atlas, JaxAtlas) else texels
        sc = dataclasses.replace(jscene, atlas=atlas,
                                 materials=dataclasses.replace(jscene.materials, emittance=emittance))
        st = dict(jst, throughput=throughput, radiance=radiance)
        out = jpt._shade(sc, st, u, jres, is_first, may_scatter)
        mat, uv, _, t = jax_resolve_hit(sc, st["origin"], st["dir"], jres)
        if sc.prims is not None:
            p_hit, p_t, p_mat, p_uv, _ = jpt._prim_hit(sc, st["origin"], st["dir"])
            use_p = p_hit & (p_t < jnp.where(jres.hit, t, jnp.inf))
            mat = jnp.where(use_p, p_mat, mat)
            uv = jnp.where(use_p[:, None], p_uv, uv)
        layer = jax_gather_rows(sc.materials, mat)["texture_index"]
        return out, jax_sample_atlas(sc.atlas, layer, uv[:, 0], uv[:, 1])

    return fn


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Per case the port's call and the JAX forward and VJP, once."""
    tmp = str(tmp_path_factory.mktemp("shade"))
    built = {}
    for i, (name, (build, is_first, may_scatter)) in enumerate(CASES.items()):
        jscene, cam = build(tmp)
        # no sun NEE on either side (K4 is the shading without it), whatever the scene's strategy
        jscene = dataclasses.replace(jscene, sun_sampling=dataclasses.replace(jscene.sun_sampling, sun_sampling=False))
        scene = scene_from_jax_arrays(jscene)
        o, d = (np.array(x) for x in jax_pixel_grid_rays(cam, W, H))
        rng = np.random.default_rng(100 + i)
        if name.startswith("room"):  # every direction from the eye: the camera does not see the ceiling
            d = rng.normal(size=d.shape)
            d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        st_np = _state(rng, o, d, scene.materials.count)
        st = {k: torch.from_numpy(v) for k, v in st_np.items()}
        u = np.array(jax_draw_uniforms(jax.random.PRNGKey(i), o.shape[0], n_bounces=1)[:, 0])
        res = tpt._trace(scene, st["origin"], st["dir"])
        prim = tpt._prim_hit(scene, st["origin"], st["dir"]) if scene.prims is not None else None
        call = (scene, st, torch.from_numpy(u), res, prim, is_first, may_scatter)
        jres = JaxHitResult(hit=jnp.asarray(res.hit.numpy()), t=jnp.asarray(res.t.numpy()),
                            face_id=jnp.asarray(res.face_id.numpy()), uv=jnp.asarray(res.uv.numpy()),
                            leaf_value=jnp.asarray(res.leaf_value.numpy().astype(np.uint32)),
                            voxel_pos=jnp.asarray(res.voxel_pos.numpy()),
                            voxel_size=jnp.asarray(res.voxel_size.numpy()), steps=jnp.int32(0))
        jst = {k: jnp.asarray(v) for k, v in st_np.items()}
        texels = jscene.atlas.data if isinstance(jscene.atlas, JaxAtlas) else jscene.atlas
        fn = _jax_shade_fn(jscene, jst, jnp.asarray(u), jres, is_first, may_scatter)
        primals = (texels, jscene.materials.emittance, jst["throughput"], jst["radiance"])
        (jout, jalb), vjp = jax.vjp(fn, *primals)
        built[name] = dict(call=call, jout=jout, jalb=np.asarray(jalb), vjp=vjp, scene=scene, jscene=jscene,
                           st_np=st_np, u=u)
    return built


def _bad_lanes(got, want):
    """(B,) bool: lanes where any float field is outside the gate or any
    integer field differs."""
    bad = np.zeros(want["active"].shape[0], bool)
    for k in FLOAT_KEYS:
        g, w = got[k], np.asarray(want[k])
        bad |= ~np.all(np.isclose(g, w, rtol=2e-3, atol=2e-3) | (np.isnan(g) & np.isnan(w)), axis=-1)
    for k in EXACT_KEYS:
        bad |= got[k] != np.asarray(want[k])
    return bad


@pytest.mark.parametrize("name", list(CASES))
def test_shade_reference_matches_jax_shade(cases, name):
    c = cases[name]
    out, _ = tshade.shade_reference(*c["call"])
    got = {k: v.numpy() for k, v in out.state.items()}
    bad = _bad_lanes(got, c["jout"])
    bad |= ~np.all(np.isclose(out.albedo.numpy(), c["jalb"], rtol=2e-3, atol=2e-3), axis=-1)
    assert bad.sum() <= 2, (name, int(bad.sum()), np.flatnonzero(bad)[:5])
    # lanes scattered, diffusely among others, unless at the depth cap
    may_scatter = c["call"][6]
    assert got["active"].any() == out.diffuse_on.numpy().any() == may_scatter


def test_emission_counts_on_the_primary_bounce_only(cases):
    """Under emitter sampling the closed room's ceiling adds its emission on
    the primary bounce, and nothing on a later one (no lane can miss)."""
    gained = {}
    for name in ("room_primary", "room_later_depth_cap"):
        out, _ = tshade.shade_reference(*cases[name]["call"])
        gained[name] = (out.state["radiance"] - cases[name]["call"][1]["radiance"]).abs().max()
    assert gained["room_primary"] > 0.1 and gained["room_later_depth_cap"] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_shade_backward_reference_matches_jax_vjp(cases, name):
    c = cases[name]
    scene, st = c["call"][0], c["call"][1]
    out, resid = tshade.shade_reference(*c["call"])
    agree = ~_bad_lanes({k: v.numpy() for k, v in out.state.items()}, c["jout"])
    # random cotangents of one sign, as a mean-radiance loss gives them: of
    # mixed signs, the lanes that share a texel could cancel to below the
    # rounding of their terms, where no two summation orders agree
    rng = np.random.default_rng(7)
    b = agree.shape[0]
    cot = {k: (rng.uniform(0.5, 1.5, size=(b, n)) * agree[:, None]).astype(np.float32)
           for k, n in (("throughput", 3), ("radiance", 3), ("albedo", 4))}
    zeros = {k: np.zeros(np.shape(v), np.asarray(v).dtype) if np.asarray(v).dtype.kind == "f"
             else np.zeros(np.shape(v), jax.dtypes.float0) for k, v in c["jout"].items()}
    want = c["vjp"]((dict(zeros, throughput=cot["throughput"], radiance=cot["radiance"]), cot["albedo"]))
    data = scene.atlas.data if isinstance(scene.atlas, Atlas) else scene.atlas
    got = tshade.shade_backward_reference(
        out.albedo, st["throughput"], resid, scene.materials.emittance, tuple(data.shape),
        *(torch.from_numpy(cot[k]) for k in ("throughput", "radiance", "albedo")))
    for label, g, w in zip(("atlas", "emittance", "throughput", "radiance"), (got[2], got[3], got[0], got[1]), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7, err_msg=f"{name}: {label}")
    assert np.abs(got[2].numpy()).max() > 0


def _loss(out, cot):
    return ((out.state["throughput"] * cot[0]).sum() + (out.state["radiance"] * cot[1]).sum()
            + (out.albedo * cot[2]).sum())


@pytest.mark.parametrize("name", ["terrain_importance", "room_primary", "world_pack", "analytic"])
def test_shade_function_cpu_route_matches_autograd_of_the_twin(cases, name):
    scene, st, u, res, prim, is_first, may_scatter = cases[name]["call"]
    data = scene.atlas.data if isinstance(scene.atlas, Atlas) else scene.atlas
    g = torch.Generator().manual_seed(3)
    cot = [torch.randn(st["throughput"].shape, generator=g), torch.randn(st["radiance"].shape, generator=g),
           torch.randn((st["throughput"].shape[0], 4), generator=g)]
    grads = []
    for route in (tshade.shade, lambda *a: tshade.shade_reference(*a)[0]):
        texels = data.clone().requires_grad_(True)
        emit = scene.materials.emittance.clone().requires_grad_(True)
        atlas = Atlas(texels, scene.atlas.sizes) if isinstance(scene.atlas, Atlas) else texels
        sc = dataclasses.replace(scene, atlas=atlas, materials=dataclasses.replace(scene.materials, emittance=emit))
        s = dict(st, throughput=st["throughput"].clone().requires_grad_(True),
                 radiance=st["radiance"].clone().requires_grad_(True))
        out = route(sc, s, u, res, prim, is_first, may_scatter)
        grads.append(torch.autograd.grad(_loss(out, cot), (texels, emit, s["throughput"], s["radiance"])))
    for label, a, b in zip(("atlas", "emittance", "throughput", "radiance"), *grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=lambda m, label=label: f"{label}: {m}")
    assert grads[0][0].abs().max() > 0


@pytest.mark.parametrize("column", ["roughness", "ior", "metalness", "specular"])
def test_shade_refuses_a_gradient_it_does_not_compute(cases, column):
    scene, st, u, res, prim, is_first, may_scatter = cases["terrain_importance"]["call"]
    mats = dataclasses.replace(scene.materials, **{column: getattr(scene.materials, column).clone().requires_grad_(True)})
    with pytest.raises(ValueError, match=column):
        tshade.shade(dataclasses.replace(scene, materials=mats), st, u, res, prim, is_first, may_scatter)


def test_shade_counts_no_launch_on_the_cpu(cases):
    before = (tshade.shade.launches, tshade.shade.backward_launches)
    scene, st, u, res, prim, is_first, may_scatter = cases["cutout"]["call"]
    texels = scene.atlas.clone().requires_grad_(True)
    out = tshade.shade(dataclasses.replace(scene, atlas=texels), st, u, res, prim, is_first, may_scatter)
    out.albedo.sum().backward()
    assert texels.grad.abs().max() > 0
    assert (tshade.shade.launches, tshade.shade.backward_launches) == before


# ---- dead lanes: since K5 compacts without shrinking the batch, every bounce
# after the first shades its dead lanes too

DEAD_CASES = ("terrain_glossy", "plant_field", "analytic", "world_pack")


def _jax_hit(res):
    return JaxHitResult(hit=jnp.asarray(res.hit.numpy()), t=jnp.asarray(res.t.numpy()),
                        face_id=jnp.asarray(res.face_id.numpy()), uv=jnp.asarray(res.uv.numpy()),
                        leaf_value=jnp.asarray(res.leaf_value.numpy().astype(np.uint32)),
                        voxel_pos=jnp.asarray(res.voxel_pos.numpy()),
                        voxel_size=jnp.asarray(res.voxel_size.numpy()), steps=jnp.int32(0))


@pytest.fixture(scope="module")
def dead_cases(cases):
    """Per case the state of ``cases`` with a seeded ~60% of its lanes dead,
    traversed as the bounce loop traverses it (a dead lane fetches nothing),
    and the JAX ``_shade`` and its VJP with the same ``active``."""
    built = {}
    for i, name in enumerate(DEAD_CASES):
        c = cases[name]
        scene, jscene = c["scene"], dataclasses.replace(c["jscene"], sun_sampling=dataclasses.replace(
            c["jscene"].sun_sampling, sun_sampling=False))
        _, _, u, _, _, is_first, may_scatter = c["call"]
        st_np = dict(c["st_np"], active=np.random.default_rng(300 + i).random(c["st_np"]["active"].shape[0]) >= 0.6)
        st = {k: torch.from_numpy(v) for k, v in st_np.items()}
        res = tpt._trace(scene, st["origin"], st["dir"], st["active"])
        prim = tpt._prim_hit(scene, st["origin"], st["dir"]) if scene.prims is not None else None
        jst = {k: jnp.asarray(v) for k, v in st_np.items()}
        texels = jscene.atlas.data if isinstance(jscene.atlas, JaxAtlas) else jscene.atlas
        fn = _jax_shade_fn(jscene, jst, jnp.asarray(c["u"]), _jax_hit(res), is_first, may_scatter)
        (jout, jalb), vjp = jax.vjp(fn, texels, jscene.materials.emittance, jst["throughput"], jst["radiance"])
        built[name] = dict(call=(scene, st, u, res, prim, is_first, may_scatter), jout=jout, jalb=np.asarray(jalb),
                           vjp=vjp, dead=~st_np["active"])
    return built


@pytest.mark.parametrize("name", DEAD_CASES)
def test_dead_lanes_pass_through_the_shading(dead_cases, name):
    """Forward: the twin against the JAX ``_shade`` with the same ``active``,
    and every state field of a dead lane bit-unchanged, with no diffuse
    hand-off.  Backward: the twin against ``jax.vjp``; a dead lane passes its
    throughput and radiance cotangents through unchanged, and cotangents on
    the dead lanes alone add nothing to the atlas or the emittance."""
    c = dead_cases[name]
    scene, st = c["call"][0], c["call"][1]
    dead = c["dead"]
    assert 0.5 < dead.mean() < 0.7
    out, resid = tshade.shade_reference(*c["call"])
    got = {k: v.numpy() for k, v in out.state.items()}
    bad = _bad_lanes(got, c["jout"])
    assert bad.sum() <= 2, (name, int(bad.sum()), np.flatnonzero(bad)[:5])
    for k, v in out.state.items():
        assert np.array_equal(v.numpy()[dead], st[k].numpy()[dead]), k
    assert not out.diffuse_on.numpy()[dead].any() and (resid.ints[:, 2].numpy()[dead] == 0).all()
    # the backward on one-signed cotangents over the lanes whose forward agrees, as the twin's test takes it
    rng = np.random.default_rng(27)
    b = dead.shape[0]
    cot = {k: (rng.uniform(0.5, 1.5, size=(b, n)) * ~bad[:, None]).astype(np.float32)
           for k, n in (("throughput", 3), ("radiance", 3), ("albedo", 4))}
    cot["albedo"][dead] = 0.0  # what the next-event half hands a dead lane
    zeros = {k: np.zeros(np.shape(v), np.asarray(v).dtype) if np.asarray(v).dtype.kind == "f"
             else np.zeros(np.shape(v), jax.dtypes.float0) for k, v in c["jout"].items()}
    want = c["vjp"]((dict(zeros, throughput=cot["throughput"], radiance=cot["radiance"]), cot["albedo"]))
    data = scene.atlas.data if isinstance(scene.atlas, Atlas) else scene.atlas

    def backward(cots):
        return tshade.shade_backward_reference(out.albedo, st["throughput"], resid, scene.materials.emittance,
                                               tuple(data.shape), *(torch.from_numpy(cots[k]) for k in
                                                                    ("throughput", "radiance", "albedo")))

    got = backward(cot)
    for label, g, w in zip(("atlas", "emittance", "throughput", "radiance"), (got[2], got[3], got[0], got[1]), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7, err_msg=f"{name}: {label}")
    for label, g in (("throughput", got[0]), ("radiance", got[1])):
        assert np.array_equal(g.numpy()[dead], cot[label][dead]), label
    only_dead = {k: v * dead[:, None] for k, v in cot.items()}
    d_tp, d_rad, d_atlas, d_emit = backward(only_dead)
    assert not d_atlas.any() and not d_emit.any()
    assert np.array_equal(d_tp.numpy(), only_dead["throughput"]) and np.array_equal(d_rad.numpy(), only_dead["radiance"])
