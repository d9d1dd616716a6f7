"""Traversal parity: the port's ESVO traversal (on the CPU, its plain-torch
twin) against the JAX ``ops.traversal.traverse`` and the scalar numpy
oracle, lane for lane; and the kernel's call path with its library replaced
by a recorder.  Kernel K1 against the twin: test_torch_gpu.py.

Gate (the repo's, test_traversal_jax.py): hit, leaf value and face id
exact; t within rtol 1e-5 / atol 1e-6 in cube units; uv within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.models import minecraft_chunk_scene as jax_chunk_scene
from octree_pathtracing_tpu.models.camera import pixel_grid_rays as jax_pixel_grid_rays
from octree_pathtracing_tpu.octree import build_from_dense, traverse_oracle
from octree_pathtracing_tpu.ops import traverse as jax_traverse
from octree_pathtracing_tpu_torch.ops import traversal
from octree_pathtracing_tpu_torch.ops.traversal import HitResult, pack_nodes, traverse, traverse_reference

MAX_DIST = 1024.0


def random_tree(rng, depth, fill=0.12):
    s = 1 << depth
    grid = (rng.random((s, s, s)) < fill).astype(np.uint32) * rng.integers(
        1, 10, size=(s, s, s)
    ).astype(np.uint32)
    return build_from_dense(grid)


def random_rays(rng, s, n):
    origins = rng.uniform(-s, 2 * s, size=(n, 3))
    targets = rng.uniform(0, s, size=(n, 3))
    d = targets - origins
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return origins.astype(np.float32), d.astype(np.float32)


def _port(tree, origins, dirs, active=None, device="cpu"):
    nodes = pack_nodes(
        torch.from_numpy(np.asarray(tree.child_mask).astype(np.int64)),
        torch.from_numpy(np.asarray(tree.child_data).astype(np.int64)),
    ).to(device)
    act = None if active is None else torch.from_numpy(active).to(device)
    res = traverse(
        nodes, tree.root, tree.depth, tree.scale(),
        torch.from_numpy(origins).to(device), torch.from_numpy(dirs).to(device), MAX_DIST, act,
    )
    return res._replace(**{k: v.cpu().numpy() for k, v in res._asdict().items() if v is not None})


def _jax(tree, origins, dirs, active=None):
    res = jax_traverse(
        jnp.asarray(tree.child_mask), jnp.asarray(tree.child_data), tree.root, tree.scale(),
        jnp.asarray(origins), jnp.asarray(dirs), max_dst=MAX_DIST, depth=tree.depth,
        active_mask=None if active is None else jnp.asarray(active),
    )
    return jax.tree.map(np.asarray, res)


def assert_same_hits(got, want, scale):
    """The traversal gate, over every lane."""
    np.testing.assert_array_equal(got.hit, want.hit)
    np.testing.assert_array_equal(got.face_id, want.face_id)
    np.testing.assert_array_equal(got.leaf_value, want.leaf_value.astype(np.int64))
    h = want.hit
    np.testing.assert_allclose(got.t[h] * scale, want.t[h] * scale, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.uv[h], want.uv[h], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.voxel_pos[h], want.voxel_pos[h], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.voxel_size[h], want.voxel_size[h], rtol=1e-6)
    assert np.isinf(got.t[~h]).all()


def _chunk_case():
    jscene, cam = jax_chunk_scene(depth=5)
    o, d = jax_pixel_grid_rays(cam, 24, 16)
    return jscene.octree, np.array(o), np.array(d)


@pytest.mark.parametrize("depth", [2, 3, 4, "chunk5"])
def test_twin_matches_jax_and_oracle(depth):
    if depth == "chunk5":
        tree, origins, dirs = _chunk_case()
    else:
        rng = np.random.default_rng(7 + depth)
        tree = random_tree(rng, depth)
        origins, dirs = random_rays(rng, 1 << depth, 256)
    got = _port(tree, origins, dirs)
    want = _jax(tree, origins, dirs)
    assert_same_hits(got, want, tree.scale())
    assert int(got.steps) == int(want.steps)  # per-lane cap == lockstep cap
    assert got.hit.any() and not got.hit.all()

    for i in range(origins.shape[0]):
        o = traverse_oracle(
            tree.child_mask, tree.child_data, tree.root, tree.scale(), origins[i], dirs[i]
        )
        assert bool(got.hit[i]) == o.hit, i
        if o.hit:
            assert got.leaf_value[i] == o.leaf_value and got.face_id[i] == o.face_id, i
            np.testing.assert_allclose(got.t[i] * tree.scale(), o.t, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got.uv[i], [o.u, o.v], rtol=1e-4, atol=1e-4)


def test_active_mask_matches_jax():
    rng = np.random.default_rng(31)
    tree = random_tree(rng, 4)
    origins, dirs = random_rays(rng, 16, 256)
    active = rng.random(256) < 0.6
    got = _port(tree, origins, dirs, active)
    want = _jax(tree, origins, dirs, active)
    assert_same_hits(got, want, tree.scale())
    assert not got.hit[~active].any()
    assert (got.face_id[~active] == -1).all() and (got.leaf_value[~active] == 0).all()
    # the inactive lanes' remaining outputs come from the initial state
    np.testing.assert_array_equal(got.uv[~active], want.uv[~active])
    np.testing.assert_array_equal(got.voxel_size, want.voxel_size)


def test_cpu_inputs_run_the_twin_and_launch_nothing():
    rng = np.random.default_rng(5)
    tree = random_tree(rng, 3)
    origins, dirs = random_rays(rng, 8, 64)
    before = traverse.launches
    got = _port(tree, origins, dirs)
    assert traverse.launches == before
    nodes = pack_nodes(torch.from_numpy(tree.child_mask.astype(np.int64)),
                       torch.from_numpy(tree.child_data.astype(np.int64)))
    ref = traverse_reference(nodes, tree.root, tree.depth, tree.scale(),
                             torch.from_numpy(origins), torch.from_numpy(dirs), MAX_DIST)
    np.testing.assert_array_equal(got.t, ref.t.numpy())
    np.testing.assert_array_equal(got.face_id, ref.face_id.numpy())
    empty = _port(tree, origins[:0], dirs[:0])
    assert empty.hit.shape == (0,) and empty.voxel_pos.shape == (0, 3) and int(empty.steps) == 0


@pytest.mark.parametrize("depth", [3, "chunk5"])
def test_steps_is_the_most_fetches_read_on_demand(depth):
    """``HitResult.steps`` is no field the call fills: it reduces ``fetches``
    where it is read, equals JAX's lockstep ``steps``, and is 0 on an empty
    batch (the twin, on the CPU)."""
    if depth == "chunk5":
        tree, origins, dirs = _chunk_case()
    else:
        rng = np.random.default_rng(41)
        tree = random_tree(rng, depth)
        origins, dirs = random_rays(rng, 8, 128)
    assert "steps" not in HitResult._fields
    nodes = pack_nodes(torch.from_numpy(np.asarray(tree.child_mask).astype(np.int64)),
                       torch.from_numpy(np.asarray(tree.child_data).astype(np.int64)))
    args = (nodes, tree.root, tree.depth, tree.scale())
    res = traverse(*args, torch.from_numpy(origins), torch.from_numpy(dirs), MAX_DIST)
    want = _jax(tree, origins, dirs)
    assert res.steps.dtype == torch.int32 and res.steps.dim() == 0
    assert int(res.steps) == int(res.fetches.max()) == int(want.steps)
    empty = traverse(*args, torch.from_numpy(origins[:0]), torch.from_numpy(dirs[:0]), MAX_DIST)
    assert int(empty.steps) == 0 and empty.fetches.shape == (0,)


@pytest.mark.parametrize("n", [0, 1, 317])
def test_cuda_call_path_is_one_entry_point_call(monkeypatch, n):
    """The kernel's call path with the library replaced by a recorder: one
    entry-point call per traversal on the current stream (nothing reduced,
    nothing filled), the launch counted once; an empty batch calls
    nothing."""
    calls = []

    class Lib:
        @staticmethod
        def esvo_traverse(*a):
            calls.append(a)
            return 0

    monkeypatch.setattr(traversal, "_library", lambda: Lib)
    monkeypatch.setattr(traversal, "on_current_stream", lambda fn, card, *a: fn(*a, "stream"))
    rng = np.random.default_rng(n)
    tree = random_tree(rng, 3)
    origins, dirs = random_rays(rng, 8, n)
    nodes = pack_nodes(torch.from_numpy(tree.child_mask.astype(np.int64)),
                       torch.from_numpy(tree.child_data.astype(np.int64)))
    before = traverse.launches
    res, rec = traversal._traverse_cuda(traverse, 0, nodes, tree.root, tree.depth, tree.scale(),
                                        torch.from_numpy(origins), torch.from_numpy(dirs), MAX_DIST, None, None)
    assert rec is None and res.hit.shape == (n,) and res.fetches.shape == (n,)
    assert len(calls) == (1 if n else 0) and traverse.launches == before + (1 if n else 0)
    if n:
        a = calls[0]
        assert a[-1] == "stream" and a[9] == n  # the ray count, after the head's nine values
        assert a[10:] == tuple(x.data_ptr() for x in res[:8]) + ("stream",)  # the outputs, fetches last


def test_pack_nodes_layout():
    mask = torch.tensor([0b0000_0011_0000_0111], dtype=torch.int64)  # slots 0-2 present, 0-1 leaves
    data = torch.tensor([[5, 7, 9, 0, 0, 0, 0, 0]], dtype=torch.int64)
    words = pack_nodes(mask, data)[0].tolist()
    assert words[0] == 5 | (1 << 30) | -(1 << 31)
    assert words[1] == 7 | (1 << 30) | -(1 << 31)
    assert words[2] == 9 | (1 << 30)
    assert words[3:] == [0] * 5
