"""The accept modes of the traversal and the relaxed-visibility loss against
the JAX package:

- the K2 twin (``traverse_alpha_reference``) against JAX ``traverse`` with
  ``render/hit.make_accept_fn``, and the K3r twin
  (``traverse_record_reference``) against JAX ``diff/soft.record_surfaces``,
  on a blocker scene whose texture has alpha holes and on
  ``cutout_chunk_scene(depth=4)``;
- ``trace_paths`` through K2 on the cutout scene, per lane;
- ``soft_radiance`` and its gradient into the blocker's texel alphas;
- ``make_inverse_loss(0.0)`` and ``make_inverse_loss(0.25)``, value and
  gradient, on fixed JAX-drawn uniform blocks, over the lanes whose
  path-traced radiance agrees per lane (a bounce ray can flip on an ulp of
  sin / cos between XLA and torch: the frame gate allows 2 such lanes, and
  one flipped lane moves the loss gradient by ~4e-5).

On the CPU the wrappers run the twins.  Gates: the traversal gate (hit,
leaf, face exact; t rtol 1e-5; uv 1e-4; record count, mats and face exact);
the integrator gate (rtol and atol 2e-3 per lane, at most 2 bad lanes);
values and gradients within rtol 1e-3 / atol 1e-5 (an ulp of sin / cos /
pow between XLA and torch, ROADMAP section 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.diff.inverse import make_inverse_loss as jax_make_inverse_loss
from octree_pathtracing_tpu.diff.soft import record_surfaces as jax_record_surfaces
from octree_pathtracing_tpu.diff.soft import soft_radiance as jax_soft_radiance
from octree_pathtracing_tpu.models import air as jax_air
from octree_pathtracing_tpu.models import cutout_chunk_scene as jax_cutout_scene
from octree_pathtracing_tpu.models import make_material_table as jax_material_table
from octree_pathtracing_tpu.models import make_scene as jax_make_scene
from octree_pathtracing_tpu.models.camera import pixel_grid_rays as jax_rays
from octree_pathtracing_tpu.models.sun import SunSampling as JaxSunSampling
from octree_pathtracing_tpu.octree import build_from_dense as jax_build
from octree_pathtracing_tpu.ops.brick_traversal import traverse_tree as jax_traverse_tree
from octree_pathtracing_tpu.ops.texture import build_atlas as jax_build_atlas
from octree_pathtracing_tpu.parallel.shard import apply_params as jax_apply_params
from octree_pathtracing_tpu.render import draw_uniforms as jax_draw_uniforms
from octree_pathtracing_tpu.render import trace_paths as jax_trace_paths
from octree_pathtracing_tpu.render.hit import make_accept_fn as jax_make_accept_fn
from octree_pathtracing_tpu_torch.diff import inverse_render, make_inverse_loss, render_views, soft_loss, soft_radiance
from octree_pathtracing_tpu_torch.models import Camera
from octree_pathtracing_tpu_torch.models.convert import scene_from_jax_arrays
from octree_pathtracing_tpu_torch.ops.traversal import (
    K_SURFACES,
    traverse,
    traverse_alpha,
    traverse_record,
)
from octree_pathtracing_tpu_torch.parallel import apply_params
from octree_pathtracing_tpu_torch.render import trace_paths
from octree_pathtracing_tpu_torch.render.hit import accept_tables, leaf_alpha_classes

MAX_DIST = 1024.0


def _solid(rgb, alpha=255, size=16):
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = rgb
    img[..., 3] = alpha
    return img


def _blocker(alpha=0.6, holes=False):
    """tests/test_diff_soft.py's blocker: a 2x2 slab in front of an opaque
    backdrop, with a ray bundle straight through it; ``holes`` punches a
    4-texel checker of alpha-0 holes into the slab's texture."""
    s = 8
    grid = np.zeros((s, s, s), np.uint32)
    grid[:, :, 7] = 2
    grid[3:5, 3:5, 3] = 1
    slab = _solid((40, 220, 40), alpha=int(round(alpha * 255)))
    if holes:
        yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
        slab[((yy // 4) + (xx // 4)) % 2 == 0, 3] = 0
    textures = [_solid((255, 0, 255)), slab, _solid((200, 60, 30))]
    materials = [jax_air(), dict(texture_index=1), dict(texture_index=2)]
    scene = jax_make_scene(jax_build(grid), jax_material_table(materials), jax_build_atlas(textures))
    xs, ys = np.meshgrid(np.linspace(2.6, 5.4, 6), np.linspace(2.6, 5.4, 6), indexing="ij")
    o = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, -2.0)], -1).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (o.shape[0], 1))
    return scene, o, d


def _cutout():
    scene, cam = jax_cutout_scene(depth=4)
    o, d = jax_rays(cam, 16, 16)
    return scene, np.array(o), np.array(d)


SCENES = {"blocker_holes": lambda: _blocker(0.6, holes=True), "cutout4": _cutout}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def walks():
    """Per scene: the JAX accept traversal, the JAX record, and the port scene."""
    out = {}
    for name, build in SCENES.items():
        jscene, o, d = build()
        jo, jd = jnp.asarray(o), jnp.asarray(d)
        hard = jax_traverse_tree(jscene.octree, jo, jd, max_dst=MAX_DIST,
                                 accept_fn=jax_make_accept_fn(jscene, jo, jd))
        out[name] = dict(
            jscene=jscene,
            scene=scene_from_jax_arrays(jscene),
            rays=(_t(o), _t(d)),
            hard=jax.tree.map(np.asarray, hard),
            record=jax.tree.map(np.asarray, jax_record_surfaces(jscene, jo, jd)),
        )
    return out


def _walk_args(case):
    s = case["scene"]
    return (s.nodes, s.root, s.depth, s.octree_scale, *case["rays"], accept_tables(s), MAX_DIST)


def _assert_same_hits(got, want, scale):
    np.testing.assert_array_equal(got.hit.numpy(), want.hit)
    np.testing.assert_array_equal(got.face_id.numpy(), want.face_id)
    np.testing.assert_array_equal(got.leaf_value.numpy(), want.leaf_value.astype(np.int64))
    h = want.hit
    np.testing.assert_allclose(got.t.numpy()[h] * scale, want.t[h] * scale, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.uv.numpy()[h], want.uv[h], rtol=1e-4, atol=1e-4)
    assert int(got.steps) == int(want.steps)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_alpha_accept_twin_matches_jax(walks, name):
    case = walks[name]
    s = case["scene"]
    assert not s.opaque_only and bool(leaf_alpha_classes(s).any())
    args = _walk_args(case)
    before = traverse_alpha.launches
    got = traverse_alpha(*args)
    assert traverse_alpha.launches == before  # CPU rays run the twin
    _assert_same_hits(got, case["hard"], s.octree_scale)
    # the accept really rejected something: the first-leaf walk differs
    first = traverse(*args[:6], MAX_DIST)
    assert bool((first.leaf_value != got.leaf_value).any() | (first.t != got.t).any())
    assert got.hit.any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_record_twin_matches_jax(walks, name):
    case = walks[name]
    res, rec = traverse_record(*_walk_args(case))
    want = case["record"]
    assert rec.mats.shape == (K_SURFACES, res.hit.shape[0])
    for k in ("count", "mats", "face"):
        np.testing.assert_array_equal(getattr(rec, k).numpy(), want[k], err_msg=k)
    for k in ("uu", "vv"):
        np.testing.assert_allclose(getattr(rec, k).numpy(), want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    assert (rec.count.numpy() >= 2).any()  # some rays cross several surfaces
    np.testing.assert_array_equal(res.hit.numpy(), want["count"] == K_SURFACES)


def test_rejectable_follows_the_live_atlas():
    jscene, _, _ = _blocker(0.6)
    scene = scene_from_jax_arrays(jscene)
    assert not leaf_alpha_classes(scene).any()
    atlas = scene.atlas.clone()
    atlas[1, 0, 0, 3] = 0.0
    assert leaf_alpha_classes(apply_params(scene, {"atlas": atlas, "emittance": scene.materials.emittance})).tolist() == [False, True, False]


@pytest.fixture(scope="module")
def cutout_frame(walks):
    """The 16x16 cutout frame through JAX and through the port, on one
    JAX-drawn block; ``agree`` marks the lanes within the integrator gate."""
    case = walks["cutout4"]
    o, d = case["rays"]
    u = np.array(jax_draw_uniforms(jax.random.PRNGKey(4), o.shape[0]))
    want = np.asarray(jax.jit(lambda o, d, u: jax_trace_paths(case["jscene"], o, d, u, tiles=1))(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(u)))
    got = trace_paths(case["scene"], o, d, _t(u)).numpy()
    agree = np.all(np.isclose(got, want, rtol=2e-3, atol=2e-3), axis=-1)
    return dict(case, u=u, want=want, got=got, agree=agree)


def test_trace_paths_through_the_alpha_accept_matches_jax(cutout_frame):
    got, bad = cutout_frame["got"], ~cutout_frame["agree"]
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert bad.sum() <= 2, (bad.sum(), np.flatnonzero(bad)[:5])


@pytest.mark.parametrize("sun", ["importance", "high_quality"])
def test_soft_radiance_and_alpha_gradient_match_jax(sun):
    """The IMPORTANCE sun, and HIGH_QUALITY, whose unoccluded sun-NEE term
    only the soft estimator computes (the hard path refuses shadow rays)."""
    jscene, o, d = _blocker(0.6)
    jscene = dataclasses.replace(jscene, sun_sampling=getattr(JaxSunSampling, sun)())
    u = np.array(jax_draw_uniforms(jax.random.PRNGKey(2), o.shape[0]))[:, 0, :]
    params = {"atlas": jscene.atlas, "emittance": jscene.materials.emittance}

    def jf(p):
        return jnp.sum(jax_soft_radiance(jax_apply_params(jscene, p), jnp.asarray(o), jnp.asarray(d), u=jnp.asarray(u)))

    jval, jgrad = jax.jit(jax.value_and_grad(jf))(params)
    scene = scene_from_jax_arrays(jscene)
    p = {"atlas": scene.atlas.clone().requires_grad_(True),
         "emittance": scene.materials.emittance.clone().requires_grad_(True)}
    rad = soft_radiance(apply_params(scene, p), _t(o), _t(d), u=_t(u))
    rad.sum().backward()
    np.testing.assert_allclose(float(rad.sum().detach()), float(jval), rtol=1e-4)
    ga = p["atlas"].grad.numpy()
    assert np.abs(ga[1, :, :, 3]).max() > 1e-3  # the silhouette gradient into alpha
    for k, g in (("atlas", ga), ("emittance", p["emittance"].grad.numpy())):
        np.testing.assert_allclose(g, np.asarray(jgrad[k]), rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("soft_weight", [0.0, 0.25])
def test_inverse_loss_matches_jax(cutout_frame, soft_weight):
    """Two views of the cutout scene (K2 in the hard term, K3r in the soft
    term) against constant targets, on the frame's fixed JAX-drawn block,
    over the lanes where the two frames agree."""
    case = cutout_frame
    jscene = case["jscene"]
    lanes = np.flatnonzero(case["agree"])
    views = 2
    b = lanes.size // views
    lanes = lanes[: views * b]
    o, d = case["rays"][0].numpy()[lanes], case["rays"][1].numpy()[lanes]
    ao, ad = o.reshape(views, b, 3), d.reshape(views, b, 3)
    all_u = case["u"][lanes].reshape(views, b, 5, -1)
    targets = np.full((views, b, 3), 0.2, np.float32)
    params = {"atlas": jscene.atlas, "emittance": jscene.materials.emittance}
    jval, jgrad = jax.jit(jax.value_and_grad(jax_make_inverse_loss(soft_weight), argnums=1))(
        jscene, params, jnp.asarray(ao), jnp.asarray(ad), jnp.asarray(all_u), jnp.asarray(targets))

    scene = case["scene"]
    p = {"atlas": scene.atlas.clone().requires_grad_(True),
         "emittance": scene.materials.emittance.clone().requires_grad_(True)}
    loss = make_inverse_loss(soft_weight)(scene, p, _t(ao), _t(ad), _t(all_u), _t(targets))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-4)
    for k in ("atlas", "emittance"):
        g = p[k].grad.numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
        np.testing.assert_allclose(g, np.asarray(jgrad[k]), rtol=1e-3, atol=1e-5, err_msg=k)


def test_soft_loss_recovers_blocker_alpha():
    """test_diff_soft.py's silhouette problem through the port: Adam on
    ``soft_loss``, projected onto the alpha channel, fades the blocker from
    alpha 0.85 to the target's 0.25 (the hard path's alpha gradient is 0)."""
    target_scene, o, d = _blocker(0.25)
    o, d = _t(o), _t(d)
    target = soft_radiance(scene_from_jax_arrays(target_scene), o, d)
    scene = scene_from_jax_arrays(_blocker(0.85)[0])
    atlas = scene.atlas.clone().requires_grad_(True)
    opt = torch.optim.Adam([atlas], lr=0.05)
    losses, touched = [], None
    for _ in range(60):
        opt.zero_grad()
        loss = soft_loss(scene, {"atlas": atlas, "emittance": scene.materials.emittance}, o, d, target)
        loss.backward()
        atlas.grad[..., :3] = 0.0  # the claim under test is the alpha gradient
        if touched is None:
            touched = atlas.grad[1, :, :, 3].abs() > 1e-7
        opt.step()
        with torch.no_grad():
            atlas.clamp_(0.0, 1.0)
        losses.append(float(loss.detach()))
    assert bool(touched.any())
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])
    rec = float(atlas.detach()[1, :, :, 3][touched].mean())
    assert abs(rec - 0.25) < 0.1, rec


def test_inverse_render_moves_occupancy():
    """test_diff_soft.py's product-path gate through the port's
    ``inverse_render``: from an almost absent blocker (alpha 0.1) against
    targets rendered with a solid one, the combined loss falls and the
    sampled alpha texels fade in."""
    scene_target = scene_from_jax_arrays(_blocker(1.0)[0])
    scene = scene_from_jax_arrays(_blocker(0.1)[0])
    cams = [Camera.look_at(eye=(4.0, 4.0, -4.0), center=(4.0, 4.0, 4.0)),
            Camera.look_at(eye=(3.0, 4.5, -4.0), center=(4.0, 4.0, 4.0))]
    targets = render_views(scene_target, cams, 12, 10, seed=7)
    init = {"atlas": scene.atlas, "emittance": scene.materials.emittance}
    res = inverse_render(scene, cams, targets, 12, 10, steps=60, lr=0.1, seed=7,
                         init_params=init, soft_weight=0.5)
    assert len(res.losses) == len(res.step_seconds) == 60
    assert res.losses[-1] < res.losses[0] * 0.7, (res.losses[0], res.losses[-1])
    rec = res.params["atlas"][1, :, :, 3].numpy()
    moved = rec[np.abs(rec - 0.102) > 0.02]  # never-sampled texels keep the init ~0.102
    assert moved.size > 0 and moved.mean() > 0.4, moved
    assert scene.atlas[1, 0, 0, 3] == init["atlas"][1, 0, 0, 3]  # the scene itself is untouched
