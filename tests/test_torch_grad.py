"""The backward of the port's path tracer: gradients of bench.py's loss (the
mean radiance of ``trace_paths`` over ``apply_params``) into the atlas and
the emittance, against ``jax.grad`` on the same JAX-drawn uniform block and
against central differences, on the sphere, the Cornell box, the
emissive room under ``EmitterSampling.ONE`` (gradients through the emitter
NEE and its shadow walk) and the analytic scene (a sphere and a quad
primitive over the ground slab: gradients through the primitives' texels);
the folded route (K7's scan inside K4's forward and ``nee_setup``, K5's
backward inside the bounces' backwards) against the route before the
folds, bit for bit; ``apply_params``; a fixed-block descent.

Gate: rtol 1e-3 / atol 1e-5 against ``jax.grad`` (XLA and torch may differ
by an ulp in sin / cos / pow, ROADMAP section 3); the central-difference
gate of tests/test_diff.py (rtol 5e-2, atol 1e-3).  On the analytic scene
one lane of the 48 flips its second bounce on such an ulp (a grazing
bounce ray that re-hits the sphere at t = 2.7e-6 in JAX and misses it in
the port, ROADMAP section 3), so there, as tests/test_torch_soft.py does,
both sides' loss is the mean over the lanes whose frames agree, and at
most one lane may disagree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.models import analytic_sphere_scene as jax_analytic
from octree_pathtracing_tpu.models import cornell_scene as jax_cornell
from octree_pathtracing_tpu.models import emissive_room_scene as jax_room
from octree_pathtracing_tpu.models import sphere_scene as jax_sphere
from octree_pathtracing_tpu.models.camera import pixel_grid_rays as jax_rays
from octree_pathtracing_tpu.parallel.shard import apply_params as jax_apply_params
from octree_pathtracing_tpu.render import draw_uniforms as jax_draw_uniforms
from octree_pathtracing_tpu.render import trace_paths as jax_trace_paths
from octree_pathtracing_tpu_torch.diff import make_inverse_loss, render_views
from octree_pathtracing_tpu_torch.models import Camera, sphere_scene
from octree_pathtracing_tpu_torch.models.convert import scene_from_jax_arrays
from octree_pathtracing_tpu_torch.ops.texture import Atlas
from octree_pathtracing_tpu_torch.parallel import apply_params, render_loss
from octree_pathtracing_tpu_torch.render import draw_uniforms, pathtracer, trace_paths
from octree_pathtracing_tpu_torch.utils.timing import unfolded

# name: (the JAX scene's builder, the uniforms' key, the loss over the lanes
# whose frames agree)
CASES = {"sphere_atlas": (jax_sphere, 0, False), "cornell_emittance": (jax_cornell, 1, False),
         "room_one": (jax_room, 2, False), "analytic_atlas": (jax_analytic, 3, True)}


def _jax_case(name):
    build, key, agreeing = CASES[name]
    jscene, cam = build(depth=3)
    o, d = jax_rays(cam, 8, 6)
    u = jax_draw_uniforms(jax.random.PRNGKey(key), o.shape[0])
    params = {"atlas": jscene.atlas, "emittance": jscene.materials.emittance}
    case = dict(scene=scene_from_jax_arrays(jscene), u=torch.from_numpy(np.array(u)), mask=None,
                rays=(torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))))
    if not agreeing:
        def loss(p):  # bench.py's loss_fn
            return jnp.mean(jax_trace_paths(jax_apply_params(jscene, p), o, d, u))

        value, grads = jax.jit(jax.value_and_grad(loss))(params)
    else:
        def loss(p, m):  # bench.py's loss_fn over the lanes of m, with the frame
            rad = jax_trace_paths(jax_apply_params(jscene, p), o, d, u)
            return jnp.sum(jnp.mean(rad, -1) * m) / jnp.sum(m), rad

        fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
        (_, rad), _ = fn(params, jnp.ones(o.shape[0], jnp.float32))
        with torch.no_grad():
            port = trace_paths(case["scene"], *case["rays"], case["u"]).numpy()
        rad = np.asarray(rad)
        agree = np.isclose(port, rad, rtol=1e-3, atol=1e-5).all(-1)
        assert (~agree).sum() <= 1, np.nonzero(~agree)
        case["mask"] = torch.from_numpy(agree.astype(np.float32))
        (value, _), grads = fn(params, jnp.asarray(agree, jnp.float32))
    return dict(case, value=float(value), grads={k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def jax_cases():
    return {name: _jax_case(name) for name in CASES}


def _port_loss(scene, rays, u, mask=None):
    def f(p):
        rad = trace_paths(apply_params(scene, p), rays[0], rays[1], u)
        return rad.mean() if mask is None else (rad.mean(-1) * mask).sum() / mask.sum()

    return f


def _port_grads(case):
    scene = case["scene"]
    p = {"atlas": scene.atlas.clone().requires_grad_(True),
         "emittance": scene.materials.emittance.clone().requires_grad_(True)}
    value = _port_loss(scene, case["rays"], case["u"], case.get("mask"))(p)
    value.backward()
    return p, float(value.detach()), {k: v.grad.numpy() for k, v in p.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax_grad(jax_cases, name):
    case = jax_cases[name]
    _, value, grads = _port_grads(case)
    np.testing.assert_allclose(value, case["value"], rtol=1e-5)
    for k in ("atlas", "emittance"):
        assert np.isfinite(grads[k]).all(), k
        np.testing.assert_allclose(grads[k], case["grads"][k], rtol=1e-3, atol=1e-5, err_msg=k)
    watched = {"sphere_atlas": "atlas", "cornell_emittance": "emittance", "room_one": "emittance",
               "analytic_atlas": "atlas"}[name]
    assert np.abs(grads[watched]).max() > 1e-3  # the case exercises its parameter


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_central_differences(jax_cases, name):
    case = jax_cases[name]
    p, _, grads = _port_grads(case)
    f = _port_loss(case["scene"], case["rays"], case["u"], case.get("mask"))
    base = {k: v.detach() for k, v in p.items()}
    if name in ("sphere_atlas", "analytic_atlas"):  # the 5 largest-|grad| texels, eps 1e-3
        probes = [("atlas", np.unravel_index(k, grads["atlas"].shape), 1e-3)
                  for k in np.argsort(np.abs(grads["atlas"]).ravel())[::-1][:5]]
    else:  # every material with a gradient, eps 1e-2
        probes = [("emittance", (m,), 1e-2) for m in range(grads["emittance"].shape[0])
                  if abs(grads["emittance"][m]) >= 1e-6]
    assert probes
    with torch.no_grad():
        for key, idx, eps in probes:
            hi, lo = base[key].clone(), base[key].clone()
            hi[idx] += eps
            lo[idx] -= eps
            fd = (float(f({**base, key: hi})) - float(f({**base, key: lo}))) / (2 * eps)
            assert np.isclose(fd, grads[key][idx], rtol=5e-2, atol=1e-3), (key, idx, fd, grads[key][idx])


@pytest.mark.parametrize("name", sorted(CASES))
def test_folded_route_is_bit_equal_to_the_route_before_the_folds(jax_cases, name):
    """The bounce loop as it runs (no compaction node: K4 and the next-event
    half take the throughput and radiance from before each compaction and
    store their gradients back through ``src``; the primitives scanned
    inside K4's forward) against the route before the folds
    (``utils/timing.unfolded``: ``CompactFunction`` with
    ``compact_backward_reference``, K7's twin handed to K4): the radiance
    and the gradients bit for bit."""
    case = jax_cases[name]
    p, value, grads = _port_grads(case)
    with unfolded(pathtracer):
        p0, value0, grads0 = _port_grads(case)
    assert value == value0
    for k in ("atlas", "emittance"):
        np.testing.assert_array_equal(grads[k], grads0[k], err_msg=k)
    assert any(np.abs(g).max() > 0 for g in grads.values())


def test_apply_params_grafts_and_keeps_the_structure_flags():
    scene, _ = sphere_scene(depth=3)
    scene = dataclasses.replace(scene, opaque_only=True, shadow_binary=False)
    atlas = torch.zeros_like(scene.atlas)  # all alpha 0: would make every leaf a hole
    emit = torch.full_like(scene.materials.emittance, 2.0)
    sp = apply_params(scene, {"atlas": atlas, "emittance": emit})
    assert sp.atlas is atlas and sp.materials.emittance is emit
    assert sp.opaque_only and not sp.shadow_binary  # as built, not from the trained alphas
    assert sp.materials.ior is scene.materials.ior and sp.nodes is scene.nodes
    # a variable-resolution scene trains the texel data only
    var = dataclasses.replace(scene, atlas=Atlas(scene.atlas.clone(), torch.tensor([[16, 16]] * 3, dtype=torch.int32)))
    sv = apply_params(var, {"atlas": atlas, "emittance": emit})
    assert isinstance(sv.atlas, Atlas) and sv.atlas.data is atlas and sv.atlas.sizes is var.atlas.sizes


def test_render_loss_is_the_photometric_mse(jax_cases):
    case = jax_cases["sphere_atlas"]
    scene, (o, d), u = case["scene"], case["rays"], case["u"]
    params = {"atlas": scene.atlas, "emittance": scene.materials.emittance}
    target = torch.full((o.shape[0], 3), 0.25)
    rad = trace_paths(scene, o, d, u)
    torch.testing.assert_close(render_loss(scene, params, o, d, u, target), ((rad - target) ** 2).mean())


def test_inverse_loss_deterministic_descent():
    """tests/test_diff.py's fixed-block descent through the port: plain
    gradient steps on a fixed uniform block lower the hard-only loss
    monotonically."""
    scene, _ = sphere_scene(depth=3)
    s = 8
    cams = [Camera.look_at(eye=(s * ex, s * 0.8, s * ez), center=(s * 0.5, s * 0.3, s * 0.5))
            for ex, ez in [(-0.5, -0.5), (1.5, -0.5)]]
    w = h = 12
    targets = render_views(scene, cams, w, h, seed=7)
    from octree_pathtracing_tpu_torch.models import pixel_grid_rays

    rays = [pixel_grid_rays(c, w, h) for c in cams]
    ao, ad = torch.stack([r[0] for r in rays]), torch.stack([r[1] for r in rays])
    all_u = torch.stack([draw_uniforms(7, 100 + v, w * h, device="cpu") for v in range(2)])
    tex = scene.atlas
    atlas = torch.full_like(tex, 0.5)
    atlas[..., 3] = tex[..., 3]
    params = {"atlas": atlas, "emittance": torch.zeros_like(scene.materials.emittance)}
    loss_fn = make_inverse_loss(0.0)
    losses = []
    for _ in range(5):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(scene, p, ao, ad, all_u, targets)
        loss.backward()
        with torch.no_grad():
            params = {k: p[k] - 0.05 * p[k].grad for k in p}
            params["atlas"].clamp_(0.0, 1.0)
            params["emittance"].clamp_(min=0.0)
        losses.append(float(loss.detach()))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_open_scene_emitter_gradient_is_finite():
    """Under ``EmitterSampling.ONE`` on a scene rays escape from, the JAX
    package's gradient turns NaN (a miss's hit point lies at infinity and
    its masked NEE term is NaN; ROADMAP section 3).  The port's gradient is
    finite, and equals JAX's wherever JAX's is finite."""
    from octree_pathtracing_tpu.models import minecraft_chunk_scene as jax_chunk
    from octree_pathtracing_tpu.models.emitters import build_emitter_table as jax_emitter_table
    from octree_pathtracing_tpu.models.sun import SunSampling as JaxSunSampling

    jscene, cam = jax_chunk(depth=4)
    jscene = dataclasses.replace(
        jscene, sun_sampling=JaxSunSampling.high_quality(), emitter_sampling="one",
        emitters=jax_emitter_table(jscene.octree, jscene.leaf_material, jscene.materials))
    o, d = jax_rays(cam, 12, 8)
    u = jax_draw_uniforms(jax.random.PRNGKey(0), o.shape[0], n_bounces=3)
    params = {"atlas": jscene.atlas, "emittance": jscene.materials.emittance}
    want = jax.jit(jax.grad(lambda p: jnp.mean(jax_trace_paths(jax_apply_params(jscene, p), o, d, u))))(params)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert np.isnan(want["atlas"]).any()

    case = dict(scene=scene_from_jax_arrays(jscene), rays=(torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))),
                u=torch.from_numpy(np.array(u)))
    _, _, grads = _port_grads(case)
    for k in ("atlas", "emittance"):
        assert np.isfinite(grads[k]).all(), k
        ok = np.isfinite(want[k])
        np.testing.assert_allclose(grads[k][ok], want[k][ok], rtol=1e-3, atol=1e-5, err_msg=k)
    assert grads["emittance"][4] > 1e-4  # the glowstone lights the frame through the NEE
