"""Kernel K4's call path (``ops/shade.shade``) on the CPU, with the CUDA
library replaced by a recorder, as test_torch_traversal.py does for the
walk: one entry-point call per forward and per backward, one output
allocation carved into every output (with a gradient, the saved albedo and
residual carved from a second of their own), the residual only where a
gradient is taken, no autograd node without one, the ``requires_grad`` refusal, and
at most one fill per backward.  The kernels themselves against their twins:
test_torch_gpu.py.  No JAX here: the file runs in under a second a test.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from octree_pathtracing_tpu_torch.models import minecraft_chunk_scene
from octree_pathtracing_tpu_torch.ops import shade as k4
from octree_pathtracing_tpu_torch.ops.shading import N_UNIFORMS
from octree_pathtracing_tpu_torch.ops.traversal import HitResult


class _Recorder:
    """K4's library: records each entry-point call, launches nothing."""

    def __init__(self):
        self.forward, self.backward = [], []

    def shade_forward(self, b, tables, flags, slots, n_slots, stream):
        self.forward.append((b, list(slots), n_slots, stream))
        return 0

    def shade_backward(self, b, slots, n_slots, stream):
        self.backward.append((b, list(slots), n_slots, stream))
        return 0

    @staticmethod
    def shade_error_string(rc):
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


@pytest.fixture(scope="module", autouse=True)
def _warm():
    """The dispatch mode's first use (torch imports its machinery then) and
    the scene, once per module."""
    with _Ops():
        torch.zeros(1)
    _call(1)


@pytest.fixture
def lib(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(k4, "_library", lambda: rec)
    monkeypatch.setattr(k4, "_uses_kernels", lambda x: True)
    monkeypatch.setattr(k4, "on_current_stream", lambda fn, card, *a: fn(*a, "stream"))
    return rec


_SCENE = []


def _call(n: int, seed: int = 0):
    """A shading call's arguments on ``n`` CPU lanes of a depth-3 terrain
    chunk: seeded state, uniforms and hits (no traversal)."""
    if not _SCENE:
        _SCENE.append(minecraft_chunk_scene(depth=3)[0])
    scene = _SCENE[0]
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    st = dict(origin=t(rng.uniform(0, 8, (n, 3)).astype(np.float32)),
              dir=t(rng.normal(size=(n, 3)).astype(np.float32)),
              throughput=t(rng.uniform(0.5, 1, (n, 3)).astype(np.float32)),
              radiance=t(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
              active=t(rng.random(n) < 0.9), specular=t(rng.random(n) < 0.5),
              cur_mat=t(np.zeros(n, np.int32)))
    u = t(rng.random((n, 5, N_UNIFORMS), dtype=np.float32))[:, 1]  # a bounce's rows of the block, strided
    res = HitResult(hit=t(rng.random(n) < 0.7), t=t(rng.uniform(1, 9, n).astype(np.float32)),
                    face_id=t(rng.integers(0, 6, n).astype(np.int32)), uv=t(rng.random((n, 2), dtype=np.float32)),
                    leaf_value=t(rng.integers(0, scene.leaf_material.shape[0], n).astype(np.int32)),
                    voxel_pos=t(np.zeros((n, 3), np.float32)), voxel_size=t(np.ones(n, np.float32)),
                    fetches=t(np.ones(n, np.int32)))
    return scene, st, u, res, None, True, True


def _outputs(out):
    return [out.state[k] for k in k4.STATE_KEYS] + [out.albedo, out.hitpoint, out.normal, out.mat, out.diffuse_on]


def _with_grad(scene, st, what):
    """``scene`` and ``st`` with ``what`` (throughput, radiance, atlas or
    emittance) requiring grad."""
    if what in ("throughput", "radiance"):
        return scene, dict(st, **{what: st[what].clone().requires_grad_(True)})
    if what == "atlas":
        return dataclasses.replace(scene, atlas=scene.atlas.clone().requires_grad_(True)), st
    m = scene.materials
    return dataclasses.replace(scene, materials=dataclasses.replace(
        m, emittance=m.emittance.clone().requires_grad_(True))), st


@pytest.mark.parametrize("grad", [None, "no_grad", "throughput", "atlas"])
@pytest.mark.parametrize("n", [0, 1, 37])
def test_forward_is_one_entry_point_call_on_one_allocation(lib, n, grad):
    scene, st, u, res, prim, is_first, may_scatter = _call(n)
    if grad not in (None, "no_grad"):
        scene, st = _with_grad(scene, st, grad)
    before = k4.shade.launches
    ops = _Ops()
    with (torch.no_grad() if grad == "no_grad" else contextlib.nullcontext()), ops:
        out = k4.shade(scene, st, u, res, prim, is_first, may_scatter)
    outs = _outputs(out)
    assert len(lib.forward) == (1 if n else 0) and k4.shade.launches == before + (1 if n else 0)
    grad_taken = grad not in (None, "no_grad")
    # one buffer; with a gradient the saved albedo and residual are a second
    assert ops.count("empty") == (2 if grad_taken else 1), ops.names
    assert ops.count("zero", "fill", "copy", "clone") == 0, ops.names
    base = outs[0].untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base for i, x in enumerate(outs) if i != 7)  # views of one buffer
    assert (outs[7].untyped_storage().data_ptr() != base) == grad_taken  # the albedo apart with a gradient
    assert [x.shape for x in outs] == [(n, 3)] * 4 + [(n,)] * 3 + [(n, 4), (n, 3), (n, 3), (n,), (n,)]
    assert [x.dtype for x in outs] == [torch.float32] * 4 + [torch.bool, torch.bool, torch.int32, torch.float32,
                                                             torch.float32, torch.float32, torch.int32, torch.bool]
    assert all(x.data_ptr() % 16 == 0 for x in outs)
    if n:
        b, slots, n_slots, stream = lib.forward[0]
        assert (b, n_slots, stream) == (n, k4.N_LANE_SLOTS, "stream")
        n_in = len(k4.IN_SLOTS)
        ins = k4._lane_inputs(scene, st, u, res, prim)
        assert slots[:n_in] == [None if x is None else x.data_ptr() for x in ins]
        assert slots[n_in:n_in + 5] == [3, 3, 3, 3, 5 * N_UNIFORMS]  # the row strides, the uniforms' of the block
        out_ptrs = slots[n_in + 5:]
        assert out_ptrs[:12] == [x.data_ptr() for x in outs]
        assert (out_ptrs[12] is None) == (grad in (None, "no_grad"))  # the residual only with a gradient
    tp = out.state["throughput"]
    if grad in (None, "no_grad"):  # no autograd node, nothing recorded for a backward
        assert tp.grad_fn is None and not tp.requires_grad and out.albedo.grad_fn is None
    else:
        assert type(tp.grad_fn).__name__ == "ShadeFunctionBackward"


@pytest.mark.parametrize("need", ["atlas", "emittance", "throughput"])
def test_backward_is_one_entry_point_call_and_at_most_one_fill(lib, need):
    scene, st, u, res, prim, is_first, may_scatter = _call(37, seed=1)
    scene, st = _with_grad(scene, st, need)
    before = k4.shade.backward_launches
    out = k4.shade(scene, st, u, res, prim, is_first, may_scatter)
    ops = _Ops()
    with ops:
        (out.state["throughput"].sum() + out.state["radiance"].sum() + out.albedo.sum()).backward()
    assert len(lib.forward) == 1 and len(lib.backward) == 1 and k4.shade.backward_launches == before + 1
    assert ops.count("zero", "fill") <= 1, ops.names
    b, slots, n_slots, stream = lib.backward[0]
    assert (b, n_slots, stream) == (37, len(k4.BACKWARD_SLOTS), "stream")
    wanted = dict(zip(k4.BACKWARD_SLOTS, slots))
    assert (wanted["d_atlas"] is not None) == (need == "atlas")
    assert (wanted["d_emittance"] is not None) == (need == "emittance")
    assert (wanted["d_throughput"] is not None) == (need == "throughput")
    assert all(wanted[k] is not None for k in ("g_throughput", "g_radiance", "g_albedo", "resid_i", "resid_f"))
    grads = {"atlas": scene.atlas, "emittance": scene.materials.emittance, "throughput": st["throughput"]}
    assert grads[need].grad is not None and grads[need].grad.shape == grads[need].shape
    if need == "atlas":  # a view of the one zero-filled buffer, which ends with no emittance part
        assert wanted["d_atlas"] == grads[need].grad.data_ptr()


def test_empty_backward_calls_nothing(lib):
    scene, st, u, res, prim, is_first, may_scatter = _call(0)
    scene, st = _with_grad(scene, st, "atlas")
    out = k4.shade(scene, st, u, res, prim, is_first, may_scatter)
    out.albedo.sum().backward()
    assert lib.forward == [] and lib.backward == [] and scene.atlas.grad.abs().max() == 0


@pytest.mark.parametrize("route", ["kernel", "twin"])
def test_refusal_of_a_gradient_k4_does_not_compute(monkeypatch, lib, route):
    if route == "twin":
        monkeypatch.setattr(k4, "_uses_kernels", lambda x: False)
    scene, st, u, res, prim, is_first, may_scatter = _call(5)
    with pytest.raises(ValueError, match=r"\['uniforms'\]"):
        k4.shade(scene, st, u.clone().requires_grad_(True), res, prim, is_first, may_scatter)
    m = dataclasses.replace(scene.materials, roughness=scene.materials.roughness.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="materials.roughness"):
        k4.shade(dataclasses.replace(scene, materials=m), st, u, res, prim, is_first, may_scatter)
    with torch.no_grad():  # nothing is recorded, so nothing is dropped
        k4.shade(scene, st, u.clone().requires_grad_(True), res, prim, is_first, may_scatter)
    assert len(lib.forward) == (1 if route == "kernel" else 0)


def test_inputs_are_checked_in_one_pass_and_a_wrong_one_named(lib):
    scene, st, u, res, prim, is_first, may_scatter = _call(9)
    with pytest.raises(ValueError, match="throughput"):
        k4.shade(scene, dict(st, throughput=st["throughput"].double()), u, res, prim, is_first, may_scatter)
    with pytest.raises(ValueError, match="uv"):
        k4.shade(scene, st, u, res._replace(uv=res.uv[:, :1]), prim, is_first, may_scatter)
    with pytest.raises(ValueError, match="active"):
        k4.shade(scene, dict(st, active=st["active"].int()), u, res, prim, is_first, may_scatter)
    assert lib.forward == []
    wide = torch.cat([st["origin"], st["origin"][:, :1]], 1)[:, :3]  # rows of 4 floats: read with their stride
    k4.shade(scene, dict(st, origin=wide), u, res, prim, is_first, may_scatter)
    assert lib.forward[0][1][len(k4.IN_SLOTS)] == 4


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("n", [1, 7, 4072])
def test_output_layout_is_aligned_and_disjoint(n, grad):
    sizes, views = k4._output_layout(n, grad)
    item = (4, 4, 1)
    assert len(sizes) == (2 if grad else 1) and sum(v is not None for v in views) == (14 if grad else 12)
    assert all(v is None for v in views[12:]) != grad
    # with a gradient the saved part (the albedo, the residual) is the second buffer, and only it
    saved = {i for i, v in enumerate(views) if v is not None and v[5] == 1}
    assert saved == ({7, 12, 13} if grad else set())
    for buf, n_bytes in enumerate(sizes):
        spans = sorted((v[4], v[4] + int(np.prod(v[1])) * item[v[3]]) for v in views if v is not None and v[5] == buf)
        assert all(start % 16 == 0 for start, _ in spans) and spans[-1][1] <= n_bytes
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
