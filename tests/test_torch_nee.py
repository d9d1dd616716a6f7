"""K4's next-event half and K6 against the JAX package: the port's
``shade_reference`` followed by ``ops/nee.nee_reference`` against the JAX
``_shade`` with its sun and emitter NEE on (render/pathtracer.py), and
``nee_backward_reference`` (composed with K4's ``shade_backward_reference``,
as the render path composes them) against ``jax.vjp`` of the same
``_shade``, on one bounce of each light-sampling kind; then
``NeeFunction``'s CPU route against torch autograd of the plain version,
its refusals, and that no launch is counted on the CPU.

Both packages shade the same state, the same ``jax.random`` uniforms and
the same hits (the port's traversal twin, carried into a JAX
``HitResult``); each casts its own shadow walks.  Forward gate, the
integrator's (test_pathtracer.py): integers and masks exact, floats within
rtol and atol 2e-3, at most 2 bad lanes.  Backward gate rtol 1e-5, atol
1e-7 (XLA and torch round sin, cos, sqrt an ulp apart), over the lanes
whose forward agrees and none of whose cast shadow rays grazes a surface:
a cosine near 0 (a ray along the shading surface, or along the emitter's
face) is a difference of nearly equal products, and the two packages'
ulp-level differences in it (XLA's CPU path fuses the multiply-adds)
become ~1e-4 of the term at a cosine of 2e-3.
"""

import dataclasses

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
from octree_pathtracing_tpu.models.camera import pixel_grid_rays as jax_pixel_grid_rays
from octree_pathtracing_tpu.models.sun import SunSampling as JaxSunSampling
from octree_pathtracing_tpu.ops.texture import Atlas as JaxAtlas
from octree_pathtracing_tpu.ops.traversal import HitResult as JaxHitResult
from octree_pathtracing_tpu.render import draw_uniforms as jax_draw_uniforms
from octree_pathtracing_tpu.render import pathtracer as jpt
from octree_pathtracing_tpu_torch.models.convert import scene_from_jax_arrays
from octree_pathtracing_tpu_torch.ops import nee as tnee
from octree_pathtracing_tpu_torch.ops import shade as tshade
from octree_pathtracing_tpu_torch.render import pathtracer as tpt

W = H = 12


def _hq(build, strict=True, depth=4):
    def make():
        jscene, cam = build(depth=depth)
        sun = dataclasses.replace(JaxSunSampling.high_quality(), strict_direct_light=strict)
        return dataclasses.replace(jscene, sun_sampling=sun), cam

    return make


def _fast():
    jscene, cam = jax_chunk_scene(depth=4)
    return dataclasses.replace(jscene, sun_sampling=JaxSunSampling.fast()), cam


def _room(sampling):
    def make():
        jscene, cam = jax_room_scene(depth=3)  # 64 emitters: ALL takes up to 64
        return dataclasses.replace(jscene, emitter_sampling=sampling), cam

    return make


# name -> (JAX scene builder, is_first)
CASES = {
    "cutout_hq_strict": (_hq(jax_cutout_scene), False),
    "cutout_hq_lenient": (_hq(jax_cutout_scene, strict=False), False),
    "terrain_fast": (_fast, False),
    "room_one": (_room("one"), False),
    "room_one_block": (_room("one_block"), False),
    "room_all": (_room("all"), True),
    "analytic_hq": (_hq(jax_analytic_scene), False),
    "plant_hq": (_hq(jax_plant_scene), False),
}
FLOAT_KEYS = ("origin", "dir", "throughput", "radiance")
EXACT_KEYS = ("active", "specular", "cur_mat")


def _state(rng, o, d, n_mat):
    b = o.shape[0]
    return dict(
        origin=o.astype(np.float32), dir=d.astype(np.float32),
        throughput=rng.uniform(0.2, 1.0, (b, 3)).astype(np.float32),
        radiance=rng.uniform(0.0, 0.5, (b, 3)).astype(np.float32),
        active=rng.random(b) < 0.9, specular=rng.random(b) < 0.5,
        cur_mat=np.zeros(b, np.int32),  # lanes in air: the strict-IOR test compares against it
    )


def _jax_shade_fn(jscene, jst, u, jres, is_first):
    """(atlas texels, emittance, throughput, radiance) -> the JAX ``_shade``'s
    state with its NEE, for jax.vjp."""

    def fn(texels, emittance, throughput, radiance):
        atlas = dataclasses.replace(jscene.atlas, data=texels) if isinstance(jscene.atlas, JaxAtlas) else texels
        sc = dataclasses.replace(jscene, atlas=atlas,
                                 materials=dataclasses.replace(jscene.materials, emittance=emittance))
        return jpt._shade(sc, dict(jst, throughput=throughput, radiance=radiance), u, jres, is_first, True)

    return fn


@pytest.fixture(scope="module")
def cases():
    """Per case the port's call and the JAX forward and VJP, once."""
    built = {}
    for i, (name, (build, is_first)) in enumerate(CASES.items()):
        jscene, cam = build()
        scene = scene_from_jax_arrays(jscene)
        o, d = (np.array(x) for x in jax_pixel_grid_rays(cam, W, H))
        rng = np.random.default_rng(200 + i)
        if name.startswith("room"):  # every direction from the eye, so that lanes see the walls and floor
            d = rng.normal(size=d.shape)
            d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        st_np = _state(rng, o, d, scene.materials.count)
        st = {k: torch.from_numpy(v) for k, v in st_np.items()}
        u = np.array(jax_draw_uniforms(jax.random.PRNGKey(10 + i), o.shape[0], n_bounces=1)[:, 0])
        res = tpt._trace(scene, st["origin"], st["dir"])
        prim = tpt._prim_hit(scene, st["origin"], st["dir"]) if scene.prims is not None else None
        call = (scene, st, torch.from_numpy(u), res, prim, is_first, True)
        jres = JaxHitResult(hit=jnp.asarray(res.hit.numpy()), t=jnp.asarray(res.t.numpy()),
                            face_id=jnp.asarray(res.face_id.numpy()), uv=jnp.asarray(res.uv.numpy()),
                            leaf_value=jnp.asarray(res.leaf_value.numpy().astype(np.uint32)),
                            voxel_pos=jnp.asarray(res.voxel_pos.numpy()),
                            voxel_size=jnp.asarray(res.voxel_size.numpy()), steps=jnp.int32(0))
        jst = {k: jnp.asarray(v) for k, v in st_np.items()}
        texels = jscene.atlas.data if isinstance(jscene.atlas, JaxAtlas) else jscene.atlas
        primals = (texels, jscene.materials.emittance, jst["throughput"], jst["radiance"])
        jout, vjp = jax.vjp(_jax_shade_fn(jscene, jst, jnp.asarray(u), jres, is_first), *primals)
        built[name] = dict(call=call, jout=jout, vjp=vjp, scene=scene, jscene=jscene, st_np=st_np, u=u)
    return built


def _port(call):
    """K4's plain version, then the next-event half's: (Shaded, K4's
    residual, the radiance, the next-event residual)."""
    out, resid = tshade.shade_reference(*call)
    rad, nres = tnee.nee_reference(call[0], call[1], call[2], out)
    return out, resid, rad, nres


GRAZING = 1e-2  # the cosine below which a cast shadow ray's term is ill-conditioned


def _grazing(call, out):
    """(B,) bool: lanes with a cast shadow ray at a cosine below ``GRAZING``
    to the shading normal, or (an emitter face's normal is an axis) to an
    axis plane."""
    scene, st, u = call[0], call[1], call[2]
    plan = tnee.nee_plan(scene)
    rays = tnee.nee_setup_reference(scene, plan, st["cur_mat"], u, out.hitpoint, out.normal, out.mat,
                                    out.diffuse_on)
    b = st["cur_mat"].shape[0]
    d = rays.dir.view(plan.faces, b, 3)
    cos_s = (d * out.normal).sum(-1).abs()
    cos_e = d.abs().amin(-1)
    if plan.sun:
        cos_e[0] = 1.0
    on = rays.active.view(plan.faces, b)
    return (on & ((cos_s < GRAZING) | (cos_e < GRAZING))).any(0).numpy()


def _bad_lanes(out, rad, want):
    """(B,) bool: lanes where any float field is outside the gate or any
    integer field differs."""
    got = {k: v.numpy() for k, v in dict(out.state, radiance=rad).items()}
    bad = np.zeros(got["active"].shape[0], bool)
    for k in FLOAT_KEYS:
        g, w = got[k], np.asarray(want[k])
        bad |= ~np.all(np.isclose(g, w, rtol=2e-3, atol=2e-3) | (np.isnan(g) & np.isnan(w)), axis=-1)
    for k in EXACT_KEYS:
        bad |= got[k] != np.asarray(want[k])
    return bad


@pytest.mark.parametrize("name", list(CASES))
def test_nee_reference_matches_jax_shade(cases, name):
    c = cases[name]
    out, _, rad, nres = _port(c["call"])
    bad = _bad_lanes(out, rad, c["jout"])
    assert bad.sum() <= 2, (name, int(bad.sum()), np.flatnonzero(bad)[:5])
    # the case exercises what it names: shadow rays were cast and light arrived
    on = (nres.ints[..., 0] & tnee.CODE_ON) != 0
    gained = (rad - out.state["radiance"]).abs().amax(-1)
    assert on.any() and bool((gained > 0).any()), name
    if name == "analytic_hq":  # the primitive's slot attenuated some sun rays
        assert bool((nres.ints[..., tnee.N_SLOTS] >= 0).any())


@pytest.mark.parametrize("name", list(CASES))
def test_nee_backward_reference_matches_jax_vjp(cases, name):
    c = cases[name]
    scene, st = c["call"][0], c["call"][1]
    out, resid, rad, nres = _port(c["call"])
    agree = ~_bad_lanes(out, rad, c["jout"]) & ~_grazing(c["call"], out)
    # random cotangents of one sign, as a mean-radiance loss gives them
    rng = np.random.default_rng(17)
    b = agree.shape[0]
    cot = {k: (rng.uniform(0.5, 1.5, size=(b, 3)) * agree[:, None]).astype(np.float32)
           for k in ("throughput", "radiance")}
    zeros = {k: np.zeros(np.shape(v), np.asarray(v).dtype) if np.asarray(v).dtype.kind == "f"
             else np.zeros(np.shape(v), jax.dtypes.float0) for k, v in c["jout"].items()}
    want = c["vjp"](dict(zeros, throughput=cot["throughput"], radiance=cot["radiance"]))
    data = scene.atlas.data if hasattr(scene.atlas, "sizes") else scene.atlas
    g_tp, g_rad = (torch.from_numpy(cot[k]) for k in ("throughput", "radiance"))
    plan = tnee.nee_plan(scene)
    n_tp, n_rad, n_alb, n_atlas, n_emit = tnee.nee_backward_reference(
        out.albedo, st["throughput"], nres, data, scene.materials.emittance, scene.sun.emittance, plan, g_rad)
    k_tp, _, k_atlas, k_emit = tshade.shade_backward_reference(
        out.albedo, st["throughput"], resid, scene.materials.emittance, tuple(data.shape), g_tp, n_rad, n_alb)
    got = (k_atlas + n_atlas, k_emit + n_emit, k_tp + n_tp, n_rad)
    for label, g, w in zip(("atlas", "emittance", "throughput", "radiance"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7, err_msg=f"{name}: {label}")
    # the terms reached the throughput, and the atlas through the albedo or the blockers and emitters
    assert np.abs(n_tp.numpy()).max() > 0 and max(np.abs(n_alb.numpy()).max(), np.abs(n_atlas.numpy()).max()) > 0


@pytest.mark.parametrize("name", ["cutout_hq_strict", "room_one_block", "analytic_hq"])
def test_nee_function_cpu_route_matches_autograd_of_the_plain_version(cases, name):
    scene, st, u, res, prim, is_first, may_scatter = cases[name]["call"]
    data = scene.atlas.data if hasattr(scene.atlas, "sizes") else scene.atlas
    g = torch.Generator().manual_seed(3)
    cot = torch.rand(st["radiance"].shape, generator=g) + 0.5
    grads = []
    for route in (tnee.nee, lambda *a: tnee.nee_reference(*a)[0]):
        texels = data.clone().requires_grad_(True)
        emit = scene.materials.emittance.clone().requires_grad_(True)
        atlas = dataclasses.replace(scene.atlas, data=texels) if hasattr(scene.atlas, "sizes") else texels
        sc = dataclasses.replace(scene, atlas=atlas, materials=dataclasses.replace(scene.materials, emittance=emit))
        s = dict(st, throughput=st["throughput"].clone().requires_grad_(True),
                 radiance=st["radiance"].clone().requires_grad_(True))
        out = tshade.shade(sc, s, u, res, prim, is_first, may_scatter)
        rad = route(sc, s, u, out)
        grads.append(torch.autograd.grad((rad * cot).sum(), (texels, emit, s["throughput"], s["radiance"])))
    for label, a, b in zip(("atlas", "emittance", "throughput", "radiance"), *grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=lambda m, label=label: f"{label}: {m}")
    assert grads[0][0].abs().max() > 0


def test_nee_refuses_a_gradient_it_does_not_compute_and_too_many_emitters(cases):
    scene, st, u, res, prim, is_first, may_scatter = cases["room_one"]["call"]
    out, _ = tshade.shade_reference(scene, st, u, res, prim, is_first, may_scatter)
    sun = dataclasses.replace(scene.sun, su=scene.sun.su.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="sun.su"):
        tnee.nee(dataclasses.replace(scene, sun=sun, sun_sampling=scene.sun_sampling), st, u, out)
    big, _ = jax_room_scene(depth=4)  # 256 emitters
    big = scene_from_jax_arrays(dataclasses.replace(big, emitter_sampling="all"))
    with pytest.raises(ValueError, match="E=256 > 64"):
        tnee.nee(big, st, u, out)


def test_nee_counts_no_launch_on_the_cpu(cases):
    counts = (tnee.nee.setup_launches, tnee.nee.resolve_launches, tnee.nee.backward_launches)
    scene, st, u, res, prim, is_first, may_scatter = cases["cutout_hq_strict"]["call"]
    texels = scene.atlas.clone().requires_grad_(True)
    sc = dataclasses.replace(scene, atlas=texels)
    out = tshade.shade(sc, st, u, res, prim, is_first, may_scatter)
    tnee.nee(sc, st, u, out).sum().backward()
    assert texels.grad.abs().max() > 0
    assert (tnee.nee.setup_launches, tnee.nee.resolve_launches, tnee.nee.backward_launches) == counts


# ---- dead lanes: since K5 compacts without shrinking the batch, every bounce
# after the first hands the next-event half its dead lanes too

DEAD_CASES = ("cutout_hq_strict", "room_one", "analytic_hq")


@pytest.fixture(scope="module")
def dead_cases(cases):
    """Per case the state of ``cases`` with ~60% of its lanes dead (seeded),
    traversed as the bounce loop traverses it, and the JAX ``_shade`` (NEE
    on) and its VJP with the same ``active``."""
    built = {}
    for i, name in enumerate(DEAD_CASES):
        c = cases[name]
        scene, jscene = c["scene"], c["jscene"]
        _, _, u, _, _, is_first, _ = c["call"]
        # ~60% dead, but 8 of the lanes that cast a shadow ray in ``cases``
        # kept live, so that the live lanes cast some at this small size
        cast = np.flatnonzero((((_port(c["call"])[3].ints[..., 0] & tnee.CODE_ON) != 0).any(0)).numpy())
        live = np.random.default_rng(400 + i).random(c["st_np"]["active"].shape[0]) >= 0.6
        live[cast[::max(1, len(cast) // 8)][:8]] = True
        st_np = dict(c["st_np"], active=live)
        st = {k: torch.from_numpy(v) for k, v in st_np.items()}
        res = tpt._trace(scene, st["origin"], st["dir"], st["active"])
        prim = tpt._prim_hit(scene, st["origin"], st["dir"]) if scene.prims is not None else None
        # A dead lane's walk misses at t = inf, and JAX's emitter terms then
        # take a point at infinity, whose masked backward is 0 * NaN (the
        # reference's fault under emitter sampling, as on a miss); the JAX
        # side gets t = 0 there, which changes none of its forward values.
        t = np.where(live, res.t.numpy(), np.float32(0.0))
        jres = JaxHitResult(hit=jnp.asarray(res.hit.numpy()), t=jnp.asarray(t),
                            face_id=jnp.asarray(res.face_id.numpy()), uv=jnp.asarray(res.uv.numpy()),
                            leaf_value=jnp.asarray(res.leaf_value.numpy().astype(np.uint32)),
                            voxel_pos=jnp.asarray(res.voxel_pos.numpy()),
                            voxel_size=jnp.asarray(res.voxel_size.numpy()), steps=jnp.int32(0))
        jst = {k: jnp.asarray(v) for k, v in st_np.items()}
        texels = jscene.atlas.data if isinstance(jscene.atlas, JaxAtlas) else jscene.atlas
        primals = (texels, jscene.materials.emittance, jst["throughput"], jst["radiance"])
        jout, vjp = jax.vjp(_jax_shade_fn(jscene, jst, jnp.asarray(c["u"]), jres, is_first), *primals)
        assert np.isinf(res.t.numpy()[~live]).all()  # the port's side keeps the walk's own t
        built[name] = dict(call=(scene, st, u, res, prim, is_first, True), jout=jout, vjp=vjp,
                           dead=~st_np["active"])
    return built


@pytest.mark.parametrize("name", DEAD_CASES)
def test_dead_lanes_pass_through_the_next_event_half(dead_cases, name):
    """Forward: K4's twin and the next-event half's plain versions against
    the JAX ``_shade`` (NEE on) with the same ``active``; a dead lane casts
    no shadow ray and keeps its radiance bit for bit.  Backward, composed
    as the render path composes it, against ``jax.vjp``; a dead lane passes
    its cotangents through, and cotangents on the dead lanes alone add
    nothing to the atlas, the emittance or the albedo."""
    c = dead_cases[name]
    scene, st = c["call"][0], c["call"][1]
    dead = c["dead"]
    assert 0.5 < dead.mean() < 0.7
    out, resid, rad, nres = _port(c["call"])
    bad = _bad_lanes(out, rad, c["jout"])
    assert bad.sum() <= 2, (name, int(bad.sum()), np.flatnonzero(bad)[:5])
    cast = ((nres.ints[..., 0] & tnee.CODE_ON) != 0).numpy()
    assert cast.any() and not cast[:, dead].any()
    assert np.array_equal(rad.numpy()[dead], st["radiance"].numpy()[dead])
    agree = ~bad & ~_grazing(c["call"], out)
    rng = np.random.default_rng(37)
    b = agree.shape[0]
    cot = {k: (rng.uniform(0.5, 1.5, size=(b, 3)) * agree[:, None]).astype(np.float32)
           for k in ("throughput", "radiance")}
    zeros = {k: np.zeros(np.shape(v), np.asarray(v).dtype) if np.asarray(v).dtype.kind == "f"
             else np.zeros(np.shape(v), jax.dtypes.float0) for k, v in c["jout"].items()}
    want = c["vjp"](dict(zeros, throughput=cot["throughput"], radiance=cot["radiance"]))
    data = scene.atlas.data if hasattr(scene.atlas, "sizes") else scene.atlas
    plan = tnee.nee_plan(scene)

    def backward(cots):
        g_tp, g_rad = (torch.from_numpy(cots[k]) for k in ("throughput", "radiance"))
        n_tp, n_rad, n_alb, n_atlas, n_emit = tnee.nee_backward_reference(
            out.albedo, st["throughput"], nres, data, scene.materials.emittance, scene.sun.emittance, plan, g_rad)
        k_tp, _, k_atlas, k_emit = tshade.shade_backward_reference(
            out.albedo, st["throughput"], resid, scene.materials.emittance, tuple(data.shape), g_tp, n_rad, n_alb)
        return k_atlas + n_atlas, k_emit + n_emit, k_tp + n_tp, n_rad, n_alb

    got = backward(cot)
    for label, g, w in zip(("atlas", "emittance", "throughput", "radiance"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7, err_msg=f"{name}: {label}")
    assert np.array_equal(got[2].numpy()[dead], cot["throughput"][dead])
    assert np.array_equal(got[3].numpy()[dead], cot["radiance"][dead])
    only_dead = {k: v * dead[:, None] for k, v in cot.items()}
    d_atlas, d_emit, d_tp, d_rad, d_alb = backward(only_dead)
    assert not d_atlas.any() and not d_emit.any() and not d_alb.any()
    assert np.array_equal(d_tp.numpy(), only_dead["throughput"]) and np.array_equal(d_rad.numpy(), only_dead["radiance"])
