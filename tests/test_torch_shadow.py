"""The shadow walk against the JAX package:

- the K3s twin (``traverse_shadow_reference``, through the CPU path of
  ``traverse_shadow``) against JAX ``_trace_stateful`` with
  ``render/hit.make_shadow_accept_fn`` on ``cutout_chunk_scene(depth=4)``,
  strict mode on and off, t recorded or not;
- ``shadow_attenuation`` (values, and the gradient into the atlas) against
  JAX's, for a sun walk and for an emitter walk truncated at ``max_t``;
- the binary walk (one first-hit traversal) against the stateful walk on an
  opaque scene, as ``test_pathtracer.py`` checks it for the JAX package.

Shadow rays start at the primaries' hit points (toward the sun or in random
directions) or come down through the canopies and the pool; they are made
with numpy from a seed and handed to both packages.  Gates: the traversal gate (hit,
face, leaf, count, mats exact; uu, vv, ts within 1e-4); values and gradients
within rtol 1e-3 / atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.models import cutout_chunk_scene as jax_cutout_scene
from octree_pathtracing_tpu.models.sun import SunSampling as JaxSunSampling
from octree_pathtracing_tpu.render import draw_uniforms as jax_draw_uniforms
from octree_pathtracing_tpu.render.hit import make_shadow_accept_fn, shadow_state_init
from octree_pathtracing_tpu.render.pathtracer import _trace_stateful
from octree_pathtracing_tpu.render.pathtracer import shadow_attenuation as jax_shadow_attenuation
from octree_pathtracing_tpu_torch.models import cornell_scene, cutout_terrain_grid, face_normals
from octree_pathtracing_tpu_torch.models.camera import pixel_grid_rays
from octree_pathtracing_tpu_torch.models.convert import scene_from_jax_arrays
from octree_pathtracing_tpu_torch.models.sun import SunSampling, random_sun_direction
from octree_pathtracing_tpu_torch.ops.shading import OFFSET
from octree_pathtracing_tpu_torch.ops.traversal import traverse_shadow
from octree_pathtracing_tpu_torch.parallel import apply_params
from octree_pathtracing_tpu_torch.render import pathtracer, trace_paths
from octree_pathtracing_tpu_torch.render.hit import accept_tables

MAX_DIST = 1024.0
WALKS = [(True, False), (False, False), (True, True), (False, True)]  # (strict, record_t)


def _shadow_rays(scene, cam, w, h, seed):
    """(origins, dirs, active, cur_mat) as numpy, 2 w h lanes.  The first
    w h start at the primaries' hit points: even lanes toward the sun, odd
    lanes in random directions of the hit face's hemisphere.  The rest come
    down from above through random voxels of the canopies (leaf value 7,
    alpha-holed) and of the pool (leaf value 5, translucent water), so that
    they cross surfaces that do not stop them; a tenth of them is
    inactive."""
    rng = np.random.default_rng(seed)
    o, d = pixel_grid_rays(cam, w, h)
    res = pathtracer._trace(scene, o, d)
    n = face_normals()[res.face_id.clamp(0, 5).long()].numpy()
    hp = np.where(res.hit.numpy()[:, None], (o + d * res.t[:, None]).numpy(), o.numpy())
    u = torch.from_numpy(rng.random((o.shape[0], 2), dtype=np.float32))
    sun = random_sun_direction(scene.sun, u[:, 0], u[:, 1]).numpy()
    rnd = rng.normal(size=(o.shape[0], 3)).astype(np.float32)
    rnd /= np.linalg.norm(rnd, axis=-1, keepdims=True)
    rnd = np.where(((rnd * n).sum(-1) < 0)[:, None], -rnd, rnd)
    dirs = np.where((np.arange(o.shape[0]) % 2 == 0)[:, None], sun, rnd)
    front = (dirs * n).sum(-1) > 0
    origins = np.where(front[:, None], hp, hp - OFFSET * n)
    active = res.hit.numpy() & front

    leaves = np.argwhere(np.isin(cutout_terrain_grid(scene.depth), (5, 7))) + 0.5
    target = leaves[rng.integers(0, len(leaves), o.shape[0])] + rng.uniform(-0.4, 0.4, (o.shape[0], 3))
    up = rng.normal(size=(o.shape[0], 3))
    up[:, 1] = np.abs(up[:, 1]) + 0.5
    up /= np.linalg.norm(up, axis=-1, keepdims=True)
    origins = np.concatenate([origins, target + 6.0 * up])
    dirs = np.concatenate([dirs, -up])
    active = np.concatenate([active, rng.random(o.shape[0]) > 0.1])
    cur_mat = rng.integers(0, scene.materials.count, 2 * o.shape[0]).astype(np.int32)
    return origins.astype(np.float32), dirs.astype(np.float32), active, cur_mat


@pytest.fixture(scope="module")
def cutout():
    """The cutout scene in both packages, its shadow rays, and the JAX walk
    of every (strict, record_t)."""
    jscene, cam = jax_cutout_scene(depth=4)
    scene = scene_from_jax_arrays(jscene)
    hp, dirs, active, cur_mat = _shadow_rays(scene, _port_camera(cam), 16, 8, 0)
    o_walk = hp + dirs * np.float32(OFFSET)
    walks = {}
    for strict, record_t in WALKS:
        res, st = _trace_stateful(
            jscene, jnp.asarray(o_walk), jnp.asarray(dirs),
            lambda sc, o, d, strict=strict: make_shadow_accept_fn(sc, o, d, strict),
            shadow_state_init(jnp.asarray(cur_mat), 4, record_t=record_t), active=jnp.asarray(active),
        )
        walks[strict, record_t] = jax.tree.map(np.asarray, (res, st))
    return dict(jscene=jscene, scene=scene, rays=(hp, dirs, active, cur_mat), o_walk=o_walk, walks=walks)


def _port_camera(jcam):
    """The port's camera for a JAX camera (same fields)."""
    from octree_pathtracing_tpu_torch.models import Camera

    return Camera(**{f.name: torch.from_numpy(np.array(getattr(jcam, f.name)))
                     for f in dataclasses.fields(Camera)})


@pytest.mark.parametrize("strict,record_t", WALKS)
def test_shadow_walk_twin_matches_jax(cutout, strict, record_t):
    s = cutout["scene"]
    _, dirs, active, cur_mat = cutout["rays"]
    res, st = traverse_shadow(
        s.nodes, s.root, s.depth, s.octree_scale, torch.from_numpy(cutout["o_walk"]),
        torch.from_numpy(dirs), accept_tables(s), torch.from_numpy(cur_mat), strict, record_t,
        MAX_DIST, torch.from_numpy(active),
    )
    want, wst = cutout["walks"][strict, record_t]
    np.testing.assert_array_equal(res.hit.numpy(), want.hit)
    np.testing.assert_array_equal(res.face_id.numpy(), want.face_id)
    np.testing.assert_array_equal(res.leaf_value.numpy(), want.leaf_value.astype(np.int64))
    assert int(res.steps) == int(want.steps)
    for f in ("count", "cm", "mats"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), wst[f], err_msg=f)
    for f in ("uu", "vv", "w"):
        np.testing.assert_allclose(getattr(st, f).numpy(), wst[f], rtol=1e-4, atol=1e-4, err_msg=f)
    if record_t:
        np.testing.assert_allclose(st.ts.numpy(), wst["ts"], rtol=1e-4, atol=1e-4)
    else:
        assert st.ts is None
    counts = np.bincount(st.count.numpy(), minlength=3)
    assert counts[1] > 0 and counts[2:].sum() > 0  # the walks cross canopies
    assert not res.fetches.numpy()[~active].any()


@pytest.mark.parametrize("walk", ["sun_strict", "emitter_max_t"])
def test_shadow_attenuation_and_atlas_gradient_match_jax(cutout, walk):
    hp, dirs, active, cur_mat = cutout["rays"]
    strict = walk == "sun_strict"
    max_t = None
    if walk == "emitter_max_t":
        max_t = np.random.default_rng(1).uniform(0.5, 6.0, hp.shape[0]).astype(np.float32)
    weights = np.random.default_rng(2).uniform(0.5, 1.5, (hp.shape[0], 4)).astype(np.float32)
    sampling = JaxSunSampling.high_quality() if strict else JaxSunSampling.fast()
    jscene = dataclasses.replace(cutout["jscene"], sun_sampling=sampling)

    def jloss(atlas):
        att = jax_shadow_attenuation(
            dataclasses.replace(jscene, atlas=atlas), jnp.asarray(hp), jnp.asarray(dirs),
            jnp.asarray(cur_mat), active=jnp.asarray(active), max_t=None if max_t is None else jnp.asarray(max_t))
        return jnp.sum(att * weights), att

    (_, want), g_want = jax.value_and_grad(jloss, has_aux=True)(jscene.atlas)

    scene = scene_from_jax_arrays(jscene)
    atlas = scene.atlas.clone().requires_grad_(True)
    sp = apply_params(scene, {"atlas": atlas, "emittance": scene.materials.emittance})
    att = pathtracer.shadow_attenuation(
        sp, torch.from_numpy(hp), torch.from_numpy(dirs), torch.from_numpy(cur_mat),
        active=torch.from_numpy(active), max_t=None if max_t is None else torch.from_numpy(max_t))
    (att * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(att.detach().numpy(), np.asarray(want), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(atlas.grad.numpy(), np.asarray(g_want), rtol=1e-3, atol=1e-5)
    assert (att[:, 3] < 1).any() and (att[:, 3] > 0).any() or not strict
    assert float(atlas.grad.abs().max()) > 0


def test_binary_walk_equals_stateful_walk():
    """An all-opaque scene's binary shadow walk (one first-hit traversal)
    equals the stateful walk, values and gradients."""
    scene, cam = cornell_scene(depth=4)
    assert scene.shadow_binary
    scene = dataclasses.replace(scene, sun_sampling=SunSampling.high_quality())
    slow = dataclasses.replace(scene, shadow_binary=False)
    o, d = pixel_grid_rays(cam, 8, 6)
    u = torch.from_numpy(np.array(jax_draw_uniforms(jax.random.PRNGKey(9), o.shape[0], n_bounces=3)))

    def run(sc):
        p = {"atlas": sc.atlas.clone().requires_grad_(True),
             "emittance": sc.materials.emittance.clone().requires_grad_(True)}
        rad = trace_paths(apply_params(sc, p), o, d, u)
        rad.mean().backward()
        return rad.detach(), p["atlas"].grad, p["emittance"].grad

    fast, ref = run(scene), run(slow)
    torch.testing.assert_close(fast[0], ref[0], rtol=0, atol=0)
    for g, w in zip(fast[1:], ref[1:]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-8)
    assert float(fast[1].abs().sum()) > 0
