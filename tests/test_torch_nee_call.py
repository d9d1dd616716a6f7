"""The call path of K4's next-event half and K6 (``ops/nee.nee``) on the
CPU, with the CUDA library replaced by a recorder, as
test_torch_shade_call.py does for K4: one entry-point call each for
``nee_setup``, ``nee_resolve`` and ``nee_backward``, ``nee_setup``'s rays
carved from one allocation with the saved ``scale`` apart, no fill or
conversion in the backward's wrapper (its float64 sums live in a per-card
scratch the kernel leaves zero), the per-scene cache of tables, plan and
flags and what makes it build a new entry, the refusals, and a scene
without light sampling costing one cached lookup.  The kernels themselves
against their plain versions: test_torch_gpu.py.  No JAX here.
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from octree_pathtracing_tpu_torch.models import emissive_room_scene, emitters, minecraft_chunk_scene
from octree_pathtracing_tpu_torch.models.sun import SunSampling
from octree_pathtracing_tpu_torch.ops import nee as k
from octree_pathtracing_tpu_torch.ops.shade import Shaded
from octree_pathtracing_tpu_torch.ops.shading import N_UNIFORMS


class _Recorder:
    """The next-event library: records each entry-point call, launches
    nothing."""

    def __init__(self):
        self.setup, self.resolve, self.backward = [], [], []

    def nee_setup(self, b, tables, flags, slots, n_slots, stream):
        self.setup.append((b, tables, flags, list(slots), n_slots, stream))
        return 0

    def nee_resolve(self, b, tables, flags, slots, n_slots, stream):
        named = dict(zip(k.RESOLVE_SLOTS, slots))
        self.resolve.append((b, tables, flags, named["out_radiance"], named["resid"] or 0, stream, list(slots),
                             n_slots))
        return 0

    def nee_backward(self, b, slots, n_slots, n_texels, n_emit, sun, em_mode, faces, stream):
        self.backward.append((b, list(slots), n_slots, n_texels, n_emit, sun, em_mode, faces, stream))
        return 0

    @staticmethod
    def nee_error_string(rc):
        return b"recorded"


class _Ops(TorchDispatchMode):
    """The names of the aten ops run inside the mode."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))

    def count(self, *words):
        return sum(any(w in n for w in words) for n in self.names)


_SCENES = {}


def _scene(name="room"):
    """The emissive room (64 emitters on a supercell grid) under the
    HIGH_QUALITY sun and one-emitter NEE: two faces a lane; or the terrain
    under IMPORTANCE, which samples no light."""
    if name not in _SCENES:
        if name == "room":
            sc = emissive_room_scene(depth=3)[0]
            _SCENES[name] = emitters.with_emitter_sampling(
                dataclasses.replace(sc, sun_sampling=SunSampling.high_quality()), "one")
        else:
            _SCENES[name] = minecraft_chunk_scene(depth=3)[0]
    return _SCENES[name]


@pytest.fixture(scope="module", autouse=True)
def _warm():
    """The dispatch mode's first use and the scenes, once per module."""
    with _Ops():
        torch.zeros(1)
    _scene("room"), _scene("terrain")


def _call(n: int, seed: int = 0, name: str = "room"):
    """(scene, st, u, out): a next-event call's arguments on ``n`` CPU lanes,
    seeded (no traversal, no shading)."""
    scene = _scene(name)
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    n_mat = scene.materials.ior.shape[0]
    st = dict(throughput=t(rng.uniform(0.5, 1, (n, 3)).astype(np.float32)),
              cur_mat=t(np.zeros(n, np.int32)))
    u = t(rng.random((n, 5, N_UNIFORMS), dtype=np.float32))[:, 1]  # a bounce's rows of the block, strided
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    out = Shaded(state=dict(radiance=t(rng.uniform(0, 1, (n, 3)).astype(np.float32))),
                 albedo=t(rng.uniform(0, 1, (n, 4)).astype(np.float32)),
                 hitpoint=t(rng.uniform(1, 7, (n, 3)).astype(np.float32)), normal=t(normal),
                 mat=t(rng.integers(0, n_mat, n).astype(np.int32)), diffuse_on=t(rng.random(n) < 0.8))
    return scene, st, u, out


_WALKS = {}


def _fake_walk(scene, plan, rays):
    """The binary walk's record for every ray: no hits, made once per ray
    count (the walks are not under test here)."""
    fb = rays.origin.shape[0]
    if fb not in _WALKS:
        _WALKS[fb] = types.SimpleNamespace(hit=torch.zeros(fb, dtype=torch.bool), t=torch.zeros(fb),
                                           face_id=torch.zeros(fb, dtype=torch.int32), uv=torch.zeros((fb, 2)),
                                           leaf_value=torch.zeros(fb, dtype=torch.int32))
    return _WALKS[fb], None


@pytest.fixture
def lib(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(k, "_library", lambda: rec)
    monkeypatch.setattr(k, "_uses_kernels", lambda x: True)
    monkeypatch.setattr(k, "on_current_stream", lambda fn, card, *a: fn(*a, "stream"))
    monkeypatch.setattr(k, "nee_walks", _fake_walk)
    return rec


def _with_grad(scene, st, out, what):
    if what == "throughput":
        return scene, dict(st, throughput=st["throughput"].clone().requires_grad_(True)), out
    if what == "atlas":
        return dataclasses.replace(scene, atlas=scene.atlas.clone().requires_grad_(True)), st, out
    m = scene.materials
    return dataclasses.replace(scene, materials=dataclasses.replace(
        m, emittance=m.emittance.clone().requires_grad_(True))), st, out


@pytest.mark.parametrize("grad", [None, "no_grad", "throughput", "atlas"])
@pytest.mark.parametrize("n", [0, 1, 37])
def test_forward_is_one_setup_and_one_resolve_on_two_ray_allocations(lib, n, grad):
    scene, st, u, out = _call(n)
    if grad not in (None, "no_grad"):
        scene, st, out = _with_grad(scene, st, out, grad)
    k.nee(scene, st, u, out)  # the scene's entry and plan, once
    lib.setup.clear(), lib.resolve.clear()
    before = (k.nee.setup_launches, k.nee.resolve_launches)
    rays = []
    real_setup = k._setup_cuda
    ops = _Ops()
    with (torch.no_grad() if grad == "no_grad" else contextlib.nullcontext()), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(k, "_setup_cuda", lambda *a: rays.append(real_setup(*a)) or rays[-1])
        with ops:
            rad = k.nee(scene, st, u, out)
    faces = k.nee_plan(scene).faces
    assert faces == 2 and len(rays) == 1
    assert (len(lib.setup), len(lib.resolve)) == ((1, 1) if n else (0, 0))
    assert (k.nee.setup_launches, k.nee.resolve_launches) == tuple(x + (1 if n else 0) for x in before)
    assert rays[0].prim is None  # a scene without primitives: no scan, no slots for it
    r = rays[0][:8]
    carved = [x for f, x in zip(k.NeeRays._fields, r) if f != "scale"]
    base = rays[0].origin.untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base for x in carved)  # views of one buffer
    assert rays[0].scale.untyped_storage().data_ptr() != base
    assert rays[0].scale.untyped_storage().nbytes() == 4 * faces * n  # the saved part: an allocation of its own
    # the rays, their scale, the radiance out, and the residual's ints with a gradient
    assert ops.count("empty") == (3 if grad in (None, "no_grad") else 4), ops.names
    assert ops.count("zero", "fill", "copy", "clone") == 0, ops.names
    assert [x.shape for x in r] == [(faces * n, 3)] * 2 + [(faces * n,)] * 6
    assert [x.dtype for x in r] == [torch.float32] * 4 + [torch.bool] + [torch.int32] * 3
    assert all(x.data_ptr() % 16 == 0 for x in r)
    if n:
        b, tables, flags, slots, n_slots, stream = lib.setup[0]
        entry = k._scene_entry(scene, k.nee_plan(scene))
        assert (b, n_slots, stream) == (n, len(k.SETUP_SLOTS), "stream")
        assert tables is entry.tables_ref and flags is entry.flags_ref and lib.resolve[0][1] is entry.tables_ref
        named = dict(zip(k.SETUP_SLOTS, slots))
        assert named["u_stride"] == 5 * N_UNIFORMS  # the uniforms read with their block's row stride
        assert [named[f] for f in k.NeeRays._fields] == [x.data_ptr() for x in r] + [None] * 4
        assert (lib.resolve[0][4] == 0) == (grad in (None, "no_grad"))  # the residual only with a gradient
    if grad in (None, "no_grad"):  # no autograd node
        assert rad.grad_fn is None and not rad.requires_grad
    else:
        assert type(rad.grad_fn).__name__ == "NeeFunctionBackward"


@pytest.mark.parametrize("need", ["atlas", "emittance", "throughput"])
def test_backward_is_one_entry_point_call_with_no_fill_or_conversion(lib, need):
    scene, st, u, out = _call(37, seed=1)
    scene, st, out = _with_grad(scene, st, out, need)
    k.nee(scene, st, u, out).sum().backward()  # the card's scratch, allocated once
    lib.backward.clear()
    for x in (scene.atlas, scene.materials.emittance, st["throughput"]):
        x.grad = None
    before = k.nee.backward_launches
    rad = k.nee(scene, st, u, out)
    ops = _Ops()
    real = k._backward_cuda

    def counted(*a):
        with ops:
            return real(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k, "_backward_cuda", counted)
        rad.backward(torch.rand(rad.shape))  # a dense cotangent, as the bounce loop hands the kernel
    assert len(lib.backward) == 1 and k.nee.backward_launches == before + 1
    assert ops.count("zero", "fill", "copy", "_to", "clone") == 0, ops.names
    assert ops.count("empty") <= 2, ops.names  # the lane gradients, the table gradients
    b, slots, n_slots, n_texels, n_emit, sun, em_mode, faces, stream = lib.backward[0]
    atlas = k._atlas_data(scene.atlas)
    assert (b, n_slots, stream) == (37, len(k.BACKWARD_SLOTS), "stream")
    assert (n_texels, n_emit, sun, em_mode, faces) == (atlas.numel() // 4, scene.materials.emittance.numel(), 1,
                                                       k.EM_MODES["one"], 2)
    named = dict(zip(k.BACKWARD_SLOTS, slots))
    assert (named["d_atlas"] is not None) == (need == "atlas") == (named["sum_atlas"] is not None)
    assert (named["d_emittance"] is not None) == (need == "emittance") == (named["sum_emittance"] is not None)
    assert (named["d_throughput"] is not None) == (need == "throughput")
    assert named["d_albedo"] is None  # the albedo here is a plain input, not K4's output
    scratch = k._SCRATCH[None][-1]
    assert scratch.dtype == torch.float64 and bool((scratch == 0).all())
    if need == "atlas":
        assert named["sum_atlas"] == scratch.data_ptr() and named["d_atlas"] == scene.atlas.grad.data_ptr()
    if need == "emittance":
        assert named["sum_emittance"] == scratch.data_ptr() + 8 * atlas.numel()
    grads = {"atlas": scene.atlas, "emittance": scene.materials.emittance, "throughput": st["throughput"]}
    assert grads[need].grad is not None and grads[need].grad.shape == grads[need].shape


def test_scratch_grows_outside_a_capture_only(lib):
    dev = torch.device("cpu")
    small = k._scratch(dev, 16)
    assert k._scratch(dev, 16) is small and k._scratch(dev, small.numel()) is small
    big = k._scratch(dev, small.numel() + 1)
    assert big is not small and big.numel() == small.numel() + 1 and bool((big == 0).all())
    assert k._SCRATCH[None][-2] is small  # kept: a graph captured with it replays against it


def test_empty_batch_launches_no_lane_work(lib):
    scene, st, u, out = _call(0)
    scene, st, out = _with_grad(scene, st, out, "throughput")
    rad = k.nee(scene, st, u, out)
    rad.sum().backward()
    assert lib.setup == [] and lib.resolve == [] and lib.backward == []
    assert st["throughput"].grad.shape == (0, 3)


def test_the_cache_notices_a_replaced_atlas_emitter_table_or_sampling_setting(lib):
    scene = _scene("room")
    plan = k._scene_plan(scene)
    entry = k._scene_entry(scene, plan)
    assert k._scene_entry(scene, plan) is entry and k._scene_plan(scene) is plan
    assert k._scene_entry(dataclasses.replace(scene), plan) is entry  # the same tables and settings
    em = scene.emitters
    same = dataclasses.replace(scene, emitters=dataclasses.replace(em))  # a new table object of the same tensors
    assert k._scene_plan(same) == plan and k._scene_entry(same, plan) is entry
    changed = {
        "atlas": dataclasses.replace(scene, atlas=scene.atlas.clone()),
        "emitter table": dataclasses.replace(scene, emitters=dataclasses.replace(em, grid_w=em.grid_w.clone())),
        "strict": dataclasses.replace(scene, sun_sampling=dataclasses.replace(scene.sun_sampling,
                                                                              strict_direct_light=False)),
        "luminosity": dataclasses.replace(scene, sun_sampling=dataclasses.replace(scene.sun_sampling,
                                                                                  sun_luminosity=False)),
        "f_sub_surface": dataclasses.replace(scene, f_sub_surface=0.5),
    }
    for what, sc in changed.items():
        e = k._scene_entry(sc, k._scene_plan(sc))
        assert e is not entry, what
    assert k._scene_entry(changed["strict"], plan).flags.strict == 0 and entry.flags.strict == 1
    assert k._scene_entry(changed["luminosity"], plan).flags.sun_luminosity == 0
    assert k._scene_entry(changed["atlas"], plan).tables.atlas == changed["atlas"].atlas.data_ptr()
    one_block = dataclasses.replace(scene, emitter_sampling="one_block")
    p2 = k._scene_plan(one_block)
    assert p2 != plan and p2.faces == 4 and k._scene_entry(one_block, p2).flags.em_mode == k.EM_MODES["one_block"]
    no_sun = dataclasses.replace(scene, sun_sampling=SunSampling.importance())
    assert k._scene_plan(no_sun).faces == 1 and not k._scene_plan(no_sun).sun


def test_a_scene_without_light_sampling_costs_one_lookup(lib, monkeypatch):
    scene, st, u, out = _call(16, name="terrain")
    assert k.nee(scene, st, u, out) is out.state["radiance"]
    plans, entries = [], []
    monkeypatch.setattr(k, "nee_plan", lambda sc: plans.append(sc))
    monkeypatch.setattr(k, "_scene_entry", lambda *a: entries.append(a))
    ops = _Ops()
    with ops:
        for _ in range(5):
            assert k.nee(scene, st, u, out) is out.state["radiance"]
    assert plans == [] and entries == [] and ops.names == []
    assert lib.setup == [] and lib.resolve == []


def test_refusals_name_the_wrong_input(lib):
    scene, st, u, out = _call(9)
    bad_out = {
        "hitpoint": out._replace(hitpoint=out.hitpoint.double()),
        "normal": out._replace(normal=out.normal[:, :2]),
        "mat": out._replace(mat=out.mat.long()),
        "diffuse_on": out._replace(diffuse_on=out.diffuse_on.int()),
        "albedo": out._replace(albedo=out.albedo[:, :3]),
        "radiance": out._replace(state=dict(radiance=out.state["radiance"].double())),
    }
    for name, o in bad_out.items():
        with pytest.raises(ValueError, match=name):
            k.nee(scene, st, u, o)
    with pytest.raises(ValueError, match="throughput"):
        k.nee(scene, dict(st, throughput=st["throughput"][:, :2]), u, out)
    with pytest.raises(ValueError, match="cur_mat"):
        k.nee(scene, dict(st, cur_mat=st["cur_mat"].long()), u, out)
    with pytest.raises(ValueError, match="uniforms"):
        k.nee(scene, st, u[:, :5], out)
    with pytest.raises(ValueError, match=r"\['uniforms'\]"):
        k.nee(scene, st, u.clone().requires_grad_(True), out)
    sun = dataclasses.replace(scene.sun, su=scene.sun.su.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="sun.su"):
        k.nee(dataclasses.replace(scene, sun=sun), st, u, out)
    em = scene.emitters
    with pytest.raises(ValueError, match="emitters.grid_idx"):
        k.nee(dataclasses.replace(scene, emitters=dataclasses.replace(em, grid_idx=em.grid_idx.long())), st, u, out)
    with pytest.raises(ValueError, match="atlas"):
        k.nee(dataclasses.replace(scene, atlas=scene.atlas.transpose(1, 2)), st, u, out)
    with pytest.raises(ValueError, match="materials.ior"):
        m = dataclasses.replace(scene.materials, ior=scene.materials.ior.double())
        k.nee(dataclasses.replace(scene, materials=m), st, u, out)
    many = dataclasses.replace(scene, emitter_sampling="all", emitters=dataclasses.replace(
        em, pos=em.pos.repeat(2, 1), size=em.size.repeat(2), mat=em.mat.repeat(2)))
    with pytest.raises(ValueError, match="E=128 > 64"):
        k.nee(many, st, u, out)
    assert lib.resolve == []  # the resolve's inputs are checked before its launch
    resid = k.NeeResidual(torch.zeros((2, 9, k.RESID_INTS), dtype=torch.int32), torch.zeros((2, 9)))
    args = (out.albedo, st["throughput"], resid, scene.atlas, scene.materials.emittance, scene.sun.emittance,
            k.nee_plan(scene))
    with pytest.raises(ValueError, match="radiance cotangent"):
        k._backward_cuda(*args, torch.ones((9, 2)), (True, True, True, True, True))
    assert lib.backward == []
    refused = types.SimpleNamespace(nee_setup=lambda *a: 1, nee_error_string=lambda rc: b"invalid argument")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k, "_library", lambda: refused)
        before = k.nee.setup_launches
        with pytest.raises(RuntimeError, match="nee_setup launch failed: invalid argument"):
            k.nee(scene, st, u, out)
        assert k.nee.setup_launches == before


@pytest.mark.parametrize("prims", [False, True])
@pytest.mark.parametrize("fb", [1, 7, 65553])
def test_ray_layout_is_aligned_and_disjoint(fb, prims):
    n_bytes, parts = k._ray_layout(fb, prims)
    item = {0: 4, 1: 4, 2: 1}
    spans = sorted((p[4], p[4] + int(np.prod(p[1])) * item[p[3]]) for p in parts.values())
    # every field but scale; K7's four only where the scene has primitives
    assert len(spans) == len(k.NeeRays._fields) - 1 - (0 if prims else 4)
    assert all(start % 16 == 0 for start, _ in spans) and spans[-1][1] <= n_bytes
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("want_grad", [False, True])
def test_resolve_is_one_entry_point_call_on_one_allocation_each(lib, want_grad):
    scene, st, u, out = _call(37, seed=2)
    plan = k.nee_plan(scene)
    entry = k._scene_entry(scene, plan)
    c = k._Call(scene, plan, st["cur_mat"], u, out.hitpoint, out.normal, out.mat, out.diffuse_on)
    rays = k._setup_cuda(c, entry)
    walk, prim = _fake_walk(scene, plan, rays)
    wide = torch.cat([out.state["radiance"], out.state["radiance"][:, :1]], 1)[:, :3]  # rows of 4 floats
    ops = _Ops()
    with ops:
        rad, resid = k._resolve_cuda(c, rays, walk, prim, st["throughput"], wide, out.albedo, want_grad, entry)
    # the radiance, and the residual's ints with a gradient (its scale is the rays' own, viewed)
    assert ops.count("empty") == (2 if want_grad else 1), ops.names
    assert ops.count("zero", "fill", "copy", "clone", "contiguous") == 0, ops.names
    assert len(lib.resolve) == 1 and rad.shape == (37, 3)
    b, tables, flags, out_ptr, resid_ptr, stream, slots, n_slots = lib.resolve[0]
    assert (b, n_slots, stream) == (37, len(k.RESOLVE_SLOTS), "stream")
    assert tables is entry.tables_ref and flags is entry.flags_ref
    named = dict(zip(k.RESOLVE_SLOTS, slots))
    assert [named[f] for f in k.RESOLVE_IN] == [x.data_ptr() for x in (out.albedo, st["throughput"], wide,
                                                                     st["cur_mat"])]
    assert (named["throughput_stride"], named["radiance_stride"]) == (3, 4)  # rows read with their stride
    assert named["on"] == rays.active.data_ptr() and named["scale"] == rays.scale.data_ptr()
    assert all(named[f] is None for f in ("count", "mats", "uu", "vv", "ts", "p_hit"))  # the binary walk's record
    assert named["hit"] == walk.hit.data_ptr() and out_ptr == rad.data_ptr()
    if want_grad:
        assert resid.ints.shape == (2, 37, k.RESID_INTS) and resid_ptr == resid.ints.data_ptr()
        assert resid.ints.data_ptr() % 16 == 0  # written as two 16-byte stores a row
        assert resid.scale.data_ptr() == rays.scale.data_ptr()
    else:
        assert resid is None and resid_ptr == 0
    with pytest.raises(ValueError, match="albedo"):
        k._resolve_cuda(c, rays, walk, prim, st["throughput"], wide, out.albedo[:, :3], want_grad, entry)
    with pytest.raises(ValueError, match="16-byte"):
        k._resolve_cuda(c, rays, walk, prim, st["throughput"], wide, torch.zeros(37 * 4 + 1)[1:].view(37, 4),
                        want_grad, entry)
    with pytest.raises(ValueError, match="throughput"):
        k._resolve_cuda(c, rays, walk, prim, st["throughput"].double(), wide, out.albedo, want_grad, entry)
    assert len(lib.resolve) == 1
