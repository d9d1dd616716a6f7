"""The final unpermute folded into the last bounce's radiance stores, on the
CPU through the plain versions: the last bounce's writer of the radiance
(K4 on a scene that samples no light, ``nee_resolve`` on one that does)
stores each row's radiance at the lane's own index, and its backward reads
the cotangent there.  Held against the route before the folds
(``utils/timing.unfolded``: the last bounce storing in row order, then
``ops/compact.unpermute``): the forward radiance bit for bit, the
gradients into the atlas, the emittance and the incoming throughput within
rtol 1e-5 / atol 1e-7, under a cotangent that differs lane by lane (a
uniform one would not see a row stored in the wrong place).  The kernels
themselves: test_torch_gpu.py; the card's call path with recorders:
test_torch_fold_call.py.  No JAX here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from octree_pathtracing_tpu_torch.models import (
    analytic_sphere_scene,
    cutout_chunk_scene,
    emissive_room_scene,
    minecraft_chunk_scene,
    pixel_grid_rays,
)
from octree_pathtracing_tpu_torch.models.emitters import with_emitter_sampling
from octree_pathtracing_tpu_torch.models.sun import SunSampling
from octree_pathtracing_tpu_torch.ops import compact as k5
from octree_pathtracing_tpu_torch.ops import nee as kn
from octree_pathtracing_tpu_torch.ops.shading import N_UNIFORMS
from octree_pathtracing_tpu_torch.parallel import apply_params
from octree_pathtracing_tpu_torch.render import pathtracer
from octree_pathtracing_tpu_torch.utils.timing import unfolded

W = H = 12
N_BOUNCES = 5


def _high_quality(scene, emitters="none"):
    return with_emitter_sampling(dataclasses.replace(scene, sun_sampling=SunSampling.high_quality()), emitters)


# name: (the scene and its camera, whether it samples light)
SCENES = {
    "chunk IMPORTANCE": (lambda: minecraft_chunk_scene(depth=3), False),
    "analytic IMPORTANCE": (lambda: analytic_sphere_scene(depth=3), False),
    "chunk HIGH_QUALITY": (lambda: _with_cam(minecraft_chunk_scene(depth=3), _high_quality), True),
    "room HIGH_QUALITY + ONE": (lambda: _with_cam(emissive_room_scene(depth=3), _high_quality, "one"), True),
    "cutout HIGH_QUALITY": (lambda: _with_cam(cutout_chunk_scene(depth=4), _high_quality), True),
}
_BUILT = {}


def _with_cam(built, fn, *a):
    scene, cam = built
    return fn(scene, *a), cam


def _scene(name):
    if name not in _BUILT:
        _BUILT[name] = SCENES[name][0]()
    return _BUILT[name]


def _frame(scene, o, d, u, seed):
    """One frame through the bounce loop as ``trace_paths`` runs it, with the
    atlas, the emittance and the first bounce's incoming throughput taking
    gradient, under a loss whose cotangent differs lane by lane.  Returns
    (radiance, {name: gradient})."""
    p = {"atlas": scene.atlas.detach().clone().requires_grad_(True),
         "emittance": scene.materials.emittance.detach().clone().requires_grad_(True)}
    sp = apply_params(scene, p)
    st = pathtracer._init_state(o, d)
    tp0 = st["throughput"].requires_grad_(True)
    st = pathtracer._bounce(sp, st, u[:, 0], True, u.shape[1] > 1)
    radiance = pathtracer._live_bounces(sp, st, u, 1, None)
    weights = torch.from_numpy(np.random.default_rng(seed).uniform(0.5, 2.0, radiance.shape).astype(np.float32))
    (radiance * weights).sum().backward()
    return radiance.detach(), {"atlas": p["atlas"].grad, "emittance": p["emittance"].grad, "throughput": tp0.grad}


def _count_unpermutes(monkeypatch):
    calls = []
    real = k5.unpermute
    monkeypatch.setattr(k5, "unpermute", lambda *a: calls.append(a[1]) or real(*a))
    return calls


@pytest.mark.parametrize("n_bounces", [N_BOUNCES, 1])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_the_folded_route_equals_the_route_through_the_unpermute(monkeypatch, name, n_bounces):
    scene, cam = _scene(name)
    assert kn.samples_light(scene) == SCENES[name][1]
    o, d = pixel_grid_rays(cam, W, H)
    u = torch.from_numpy(np.random.default_rng(11).random((W * H, n_bounces, N_UNIFORMS), dtype=np.float32))
    calls = _count_unpermutes(monkeypatch)
    rad, grads = _frame(scene, o, d, u, seed=12)
    assert calls == []  # no frame launches the standalone unpermute
    with unfolded(pathtracer):
        rad0, grads0 = _frame(scene, o, d, u, seed=12)
    assert len(calls) == (1 if n_bounces > 1 else 0)  # the route before the fold: one, after the last bounce
    assert torch.equal(rad, rad0)
    for k in ("atlas", "emittance", "throughput"):
        torch.testing.assert_close(grads[k], grads0[k], rtol=1e-5, atol=1e-7, msg=lambda m, k=k: f"{k}: {m}")
    if n_bounces > 1:  # the gradients are not all zero (a frame of one bounce scatters nothing)
        assert float(grads["throughput"].abs().max()) > 0 and float(grads["atlas"].abs().max()) > 0
    with torch.no_grad():  # the frame as the entry point runs it, without a gradient
        assert torch.equal(pathtracer.trace_paths(scene, o, d, u), rad)


@pytest.mark.parametrize("name", ["chunk IMPORTANCE", "room HIGH_QUALITY + ONE"])
def test_the_branched_frame_folds_the_unpermute_too(monkeypatch, name):
    scene, cam = _scene(name)
    o, d = pixel_grid_rays(cam, 8, 8)
    u = torch.from_numpy(np.random.default_rng(13).random((64, 3, N_BOUNCES, N_UNIFORMS), dtype=np.float32))
    calls = _count_unpermutes(monkeypatch)
    p = {"atlas": scene.atlas.detach().clone().requires_grad_(True), "emittance": scene.materials.emittance}
    rad = pathtracer.trace_paths_branched(apply_params(scene, p), o, d, u)
    weights = torch.from_numpy(np.random.default_rng(14).uniform(0.5, 2.0, rad.shape).astype(np.float32))
    (rad * weights).sum().backward()
    assert calls == []
    with unfolded(pathtracer):
        p0 = {"atlas": scene.atlas.detach().clone().requires_grad_(True), "emittance": scene.materials.emittance}
        rad0 = pathtracer.trace_paths_branched(apply_params(scene, p0), o, d, u)
        (rad0 * weights).sum().backward()
    assert len(calls) == 1 and calls[0].shape == (64 * 3,)
    assert torch.equal(rad.detach(), rad0.detach())
    torch.testing.assert_close(p["atlas"].grad, p0["atlas"].grad, rtol=1e-5, atol=1e-7)


def test_the_writer_is_k4_or_nee_resolve_by_the_scenes_plan(monkeypatch):
    """``_shade`` gives ``idx`` to K4 where the scene samples no light and
    to the next-event half where it does; ``nee`` refuses an ``idx`` on a
    scene with no plan (K4 writes the radiance there)."""
    seen = []
    real_shade, real_nee = pathtracer.shade, pathtracer.nee
    monkeypatch.setattr(pathtracer, "shade", lambda *a: seen.append(("shade", a[7] if len(a) > 7 else None))
                        or real_shade(*a))
    monkeypatch.setattr(pathtracer, "nee", lambda *a, **kw: seen.append(("nee", kw.get("idx"))) or real_nee(*a, **kw))
    for name, light in (("chunk IMPORTANCE", False), ("chunk HIGH_QUALITY", True)):
        scene, cam = _scene(name)
        o, d = pixel_grid_rays(cam, 4, 4)
        u = torch.from_numpy(np.random.default_rng(15).random((16, 3, N_UNIFORMS), dtype=np.float32))
        seen.clear()
        pathtracer.trace_paths(scene, o, d, u)
        given = [(who, x is not None) for who, x in seen]
        last = [("shade", not light), ("nee", light)]
        assert given == [("shade", False), ("nee", False)] * 2 + last, (name, given)
    scene = _scene("chunk IMPORTANCE")[0]
    with pytest.raises(ValueError, match="give idx to K4"):
        kn.nee(scene, {}, None, None, idx=torch.zeros(3, dtype=torch.int32))
