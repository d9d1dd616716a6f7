"""The folds of K7 and of K5's backward on the card route, on the CPU with
every CUDA library replaced by a recorder (as test_torch_shade_call.py,
test_torch_nee_call.py and test_torch_compact_call.py do for one kernel
each): a bounce of a scene with primitives is one ``shade`` entry-point
call, the variant that scans them, and no K7 call; a light bounce's
``nee_setup`` writes K7's slots and its walks make no K7 call; the bounce
loop's compaction returns ``src`` as an allocation of its own and makes no
autograd node; a fwd+bwd over a compacted bounce calls no
``compact_backward``, and K4's backward and ``nee_backward`` receive
``src`` and store the gradient of the throughput from before the
compaction; the last bounce's writer of the radiance (K4 on a scene that
samples no light, ``nee_resolve`` on one that does) receives the
compaction's ``idx`` and its backward reads the cotangent through it, and
no ``unpermute`` is called either way.  The kernels themselves:
test_torch_gpu.py.  No JAX here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from octree_pathtracing_tpu_torch.models import analytic_sphere_scene
from octree_pathtracing_tpu_torch.models import prims as k7
from octree_pathtracing_tpu_torch.models.sun import SunSampling
from octree_pathtracing_tpu_torch.ops import compact as k5
from octree_pathtracing_tpu_torch.ops import nee as kn
from octree_pathtracing_tpu_torch.ops import shade as k4
from octree_pathtracing_tpu_torch.ops.shading import N_UNIFORMS
from octree_pathtracing_tpu_torch.ops.traversal import HitResult
from octree_pathtracing_tpu_torch.render import pathtracer

N_BOUNCES = 2


class _Recorder:
    """Every library the bounce loop calls on the card: records each
    entry-point call by name, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("_error_string"):
            return lambda rc: b"recorded"
        if name == "compact_scratch_words":
            return lambda b: 2 + max(1, -(-b // 256))

        def record(*a):
            self.calls.append((name, a))
            return 0

        return record

    def named(self, name):
        return [a for n, a in self.calls if n == name]


_SCENES = {}


def _scene(sun: str):
    """The analytic scene (a sphere and a quad primitive over the ground
    slab) at depth 3 under ``sun``: IMPORTANCE samples no light,
    HIGH_QUALITY casts one sun ray a lane."""
    if sun not in _SCENES:
        sc = analytic_sphere_scene(depth=3)[0]
        _SCENES[sun] = dataclasses.replace(sc, sun_sampling=getattr(SunSampling, sun)())
    return _SCENES[sun]


def _no_hits(n):
    t = torch.zeros
    return HitResult(hit=t(n, dtype=torch.bool), t=t(n), face_id=t(n, dtype=torch.int32), uv=t((n, 2)),
                     leaf_value=t(n, dtype=torch.int32), voxel_pos=t((n, 3)), voxel_size=t(n),
                     fetches=t(n, dtype=torch.int32))


def _no_walk(*a, **kw):
    """Every walk's record: no hit (the walks are not under test here)."""
    return _no_hits(a[4].shape[0])


@pytest.fixture
def lib(monkeypatch):
    rec = _Recorder()
    k7_calls = []
    for mod in (k4, kn, k5):
        monkeypatch.setattr(mod, "_library", lambda: rec)
        monkeypatch.setattr(mod, "_uses_kernels", lambda x: True)
        monkeypatch.setattr(mod, "on_current_stream", lambda fn, card, *a: fn(*a, "stream"))
    for mod in (pathtracer, kn):  # K7 by any route
        monkeypatch.setattr(mod, "intersect_prims", lambda *a: k7_calls.append(a))
    monkeypatch.setattr(k7, "intersect_prims_reference", lambda *a: k7_calls.append(a))
    monkeypatch.setattr(k7, "_library", lambda: rec)
    for name in ("traverse", "traverse_alpha", "traverse_shadow"):
        monkeypatch.setattr(kn, name, _no_walk)
    monkeypatch.setattr(pathtracer, "_trace", lambda scene, o, d, active=None: _no_hits(o.shape[0]))
    k5._plan.cache_clear()
    rec.k7_calls = k7_calls
    yield rec
    k5._plan.cache_clear()  # no plan made with the recorder outlives the test


def _state(b: int, seed: int = 0):
    """A lane state of ``b`` CPU lanes (about half of them live) and a
    frame's uniform block, seeded."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    st = dict(origin=t(rng.uniform(0, 8, (b, 3)).astype(np.float32)), dir=t(rng.normal(size=(b, 3)).astype(np.float32)),
              throughput=t(rng.uniform(0.5, 1, (b, 3)).astype(np.float32)),
              radiance=t(rng.uniform(0, 1, (b, 3)).astype(np.float32)), active=t(rng.random(b) < 0.5),
              specular=t(rng.random(b) < 0.5), cur_mat=t(np.zeros(b, np.int32)))
    return st, t(rng.random((b, N_BOUNCES, N_UNIFORMS), dtype=np.float32))


@pytest.mark.parametrize("sun", ["importance", "high_quality"])
def test_a_bounce_with_primitives_is_one_scanning_shade_call_and_no_k7(lib, sun):
    scene = _scene(sun)
    st, u = _state(37)
    out = pathtracer._shade(scene, st, u[:, 0], _no_hits(37), True, True)
    assert out["radiance"].shape == (37, 3)
    (fwd,) = lib.named("shade_forward")
    b, tables, flags, slots, n_slots, stream = fwd
    named = dict(zip(k4.IN_SLOTS, slots))
    assert b == 37 and flags._obj.scan == 1  # the variant with K7's scan folded in
    assert all(named[f] is None for f in ("p_hit", "p_t", "p_mat", "p_uv", "p_normal"))  # no K7 hit read
    assert tables._obj.prims.spheres.count == 1 and tables._obj.prims.quads.count == 1
    assert tables._obj.prim_t_max == 1024.0
    assert not lib.named("prims_intersect") and not lib.k7_calls  # no K7 by any route
    if sun == "high_quality":  # a light bounce: nee_setup writes K7's slots, the walks launch no K7
        (setup,) = lib.named("nee_setup")
        named = dict(zip(kn.SETUP_SLOTS, setup[3]))
        assert all(named[f] for f in ("p_hit", "p_t", "p_mat", "p_uv"))
        (resolve,) = lib.named("nee_resolve")
        r_named = dict(zip(kn.RESOLVE_SLOTS, resolve[3]))
        assert [r_named[f] for f in ("p_hit", "p_t", "p_mat", "p_uv")] == [named[f] for f in
                                                                          ("p_hit", "p_t", "p_mat", "p_uv")]
    else:
        assert not lib.named("nee_setup")


def test_a_caller_that_hands_k4_a_k7_hit_takes_the_variant_that_reads_it(lib):
    scene = _scene("importance")
    st, u = _state(5)
    hit = (torch.zeros(5, dtype=torch.bool), torch.full((5,), float("inf")), torch.zeros(5, dtype=torch.int32),
           torch.zeros((5, 2)), torch.zeros((5, 3)))
    k4.shade(scene, st, u[:, 0], _no_hits(5), hit, True, True)
    (fwd,) = lib.named("shade_forward")
    named = dict(zip(k4.IN_SLOTS, fwd[3]))
    assert fwd[2]._obj.scan == 0 and named["p_hit"] == hit[0].data_ptr()


def test_the_bounce_loops_compaction_returns_src_as_an_allocation_of_its_own(lib):
    st, u = _state(300, seed=1)
    st["throughput"].requires_grad_(True)
    out, u_b = pathtracer.compact_for_bounce(st, u, 1)
    (fwd,) = lib.named("compact_forward")
    slots = dict(zip(k5.FORWARD_SLOTS, fwd[1]))
    lanes = out["lanes"]
    assert isinstance(lanes, k5.Lanes) and lanes.throughput is st["throughput"] and lanes.radiance is st["radiance"]
    assert slots["src"] == lanes.src.data_ptr() and slots["pos"] != slots["src"]
    assert lanes.src.shape == (300,) and lanes.src.dtype == torch.int32
    others = [v for k, v in out.items() if k != "lanes"] + [u_b]
    assert lanes.src.untyped_storage().nbytes() == 4 * 300  # saved by the bounce's nodes: nothing else kept alive
    assert all(x.untyped_storage().data_ptr() != lanes.src.untyped_storage().data_ptr() for x in others)
    assert all(v.grad_fn is None and not v.requires_grad for k, v in out.items() if k != "lanes")  # no node
    with torch.no_grad():  # without a gradient: compact's own call, no src, no lanes
        out2, _ = pathtracer.compact_for_bounce(st, u, 1)
    assert "lanes" not in out2 and dict(zip(k5.FORWARD_SLOTS, lib.named("compact_forward")[1][1]))["src"] is None


@pytest.mark.parametrize("sun", ["importance", "high_quality"])
def test_fwd_bwd_over_a_compacted_bounce_calls_no_compact_backward(lib, sun):
    scene = _scene(sun)
    st, u = _state(64, seed=2)
    tp = st["throughput"].clone().requires_grad_(True)
    rad = st["radiance"].clone().requires_grad_(True)
    st = dict(st, throughput=tp, radiance=rad)
    before = k5.compact.backward_launches
    out = pathtracer._live_bounces(scene, st, u, 1, None)
    out.sum().backward()
    assert not lib.named("compact_backward") and k5.compact.backward_launches == before
    (fwd,) = lib.named("compact_forward")
    src = dict(zip(k5.FORWARD_SLOTS, fwd[1]))["src"]
    assert src
    (k4_bwd,) = lib.named("shade_backward")
    named = dict(zip(k4.BACKWARD_SLOTS, k4_bwd[1]))
    assert named["src"] == src and named["d_throughput"] and named["d_radiance"]
    assert tp.grad is not None and rad.grad is not None  # the gradients reach the rows from before the compaction
    if sun == "high_quality":
        (nee_bwd,) = lib.named("nee_backward")
        assert dict(zip(kn.BACKWARD_SLOTS, nee_bwd[1]))["src"] == src
    else:
        assert not lib.named("nee_backward")


def test_fwd_bwd_of_a_first_bounce_stores_directly(lib):
    scene = _scene("high_quality")
    st, u = _state(16, seed=3)
    st = dict(st, throughput=st["throughput"].clone().requires_grad_(True))
    out = pathtracer._shade(scene, st, u[:, 0], _no_hits(16), True, True)
    (out["radiance"].sum() + out["throughput"].sum()).backward()
    (k4_bwd,) = lib.named("shade_backward")
    (nee_bwd,) = lib.named("nee_backward")
    assert dict(zip(k4.BACKWARD_SLOTS, k4_bwd[1]))["src"] is None
    assert dict(zip(k4.BACKWARD_SLOTS, k4_bwd[1]))["d_radiance"] is None  # the cotangent passes through as it is
    assert dict(zip(kn.BACKWARD_SLOTS, nee_bwd[1]))["src"] is None


def test_cpu_route_gathers_the_gradients_through_pos(monkeypatch):
    """On the CPU the same structure runs with the plain versions: K4's and
    the next-event half's plain backwards, each storing its rows' gradients
    through ``src`` as the kernels do (``store_at_src_reference``), and no
    compaction node.  ``src`` is the inverse of the plain compaction's
    ``pos``, so the throughput's gradient is the sum of the two gathered
    through ``pos`` (``compact_backward_reference``), bit for bit."""
    scene = _scene("high_quality")
    st, u = _state(48, seed=4)
    tp = st["throughput"].clone().requires_grad_(True)
    st = dict(st, throughput=tp)
    calls = []
    real = k5.store_at_src_reference
    monkeypatch.setattr(k5, "store_at_src_reference", lambda *a: calls.append(a) or real(*a))
    monkeypatch.setattr(pathtracer, "_trace", lambda scene, o, d, active=None: _no_hits(o.shape[0]))
    out, _ = pathtracer.compact_for_bounce(st, u, 1)
    src = out["lanes"].src
    assert out["throughput"].grad_fn is None
    with torch.no_grad():
        pos = k5.compact_reference(st, u, 1)[2]
    assert torch.equal(src[pos.long()], torch.arange(48, dtype=torch.int32))
    res = pathtracer._bounce(scene, out, u[:, 1], False, False)
    res["radiance"].sum().backward()
    assert len(calls) == 2 and all(c[0] is src for c in calls)  # K4's and the next-event half's
    gathered = [k5.compact_backward_reference(pos, c[1], None)[0] for c in calls]
    assert tp.grad is not None and torch.equal(tp.grad, gathered[0] + gathered[1])


@pytest.mark.parametrize("sun", ["importance", "high_quality"])
def test_the_last_bounce_stores_the_radiance_at_idx_and_calls_no_unpermute(lib, sun):
    scene = _scene(sun)
    light = sun == "high_quality"
    st, u = _state(64, seed=5)
    st = dict(st, throughput=st["throughput"].clone().requires_grad_(True))
    before = (k5.unpermute.launches, k5.unpermute.backward_launches)
    out = pathtracer._live_bounces(scene, st, u, 1, None)  # a block of 2 bounces: bounce 1 is the last
    out.sum().backward()
    assert not lib.named("unpermute") and (k5.unpermute.launches, k5.unpermute.backward_launches) == before
    (fwd,) = lib.named("compact_forward")
    idx = dict(zip(k5.FORWARD_SLOTS, fwd[1]))["out_idx"]
    assert idx
    (k4_fwd,) = lib.named("shade_forward")
    (k4_bwd,) = lib.named("shade_backward")
    k4_named = dict(zip(k4.BACKWARD_SLOTS, k4_bwd[1]))
    assert dict(zip(k4.IN_SLOTS, k4_fwd[3]))["idx"] == (None if light else idx)
    assert k4_named["idx"] == (None if light else idx)
    if light:  # nee_resolve writes the final radiance; its backward hands K4 the cotangent in row order
        (resolve,) = lib.named("nee_resolve")
        (nee_bwd,) = lib.named("nee_backward")
        nee_named = dict(zip(kn.BACKWARD_SLOTS, nee_bwd[1]))
        assert dict(zip(kn.RESOLVE_SLOTS, resolve[3]))["idx"] == idx
        assert nee_named["idx"] == idx and nee_named["d_radiance"]
        assert k4_named["g_radiance"] == nee_named["d_radiance"]
    else:
        assert not lib.named("nee_resolve") and not lib.named("nee_backward")
