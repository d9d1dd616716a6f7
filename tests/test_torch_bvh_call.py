"""Kernel K8's call path (``ops/bvh.bvh_intersect_quads`` on the card
route), on the CPU with the library replaced by a recorder: one
entry-point call with the stack's entries per ray (the tree's depth + 1,
the depth computed once per BVH and kept by ``BVH.to``), and the refusal
of a tree deeper than the kernel's stack, with no call made and no
fallback to the twin.  The kernel itself: test_torch_gpu.py; the twin
against JAX: test_torch_bvh.py.  No JAX here.
"""

import numpy as np
import pytest
import torch

from octree_pathtracing_tpu_torch.ops import bvh as k8
from octree_pathtracing_tpu_torch.ops.geometry import make_quads


class _Recorder:
    def __init__(self):
        self.calls = []

    def bvh_intersect(self, *a):
        self.calls.append(a)
        return 0

    def bvh_error_string(self, rc):
        return b"recorded"


@pytest.fixture
def lib(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(k8, "_library", lambda: rec)
    monkeypatch.setattr(k8, "_uses_kernels", lambda x: True)
    monkeypatch.setattr(k8, "on_current_stream", lambda fn, card, *a: fn(*a, "stream"))
    monkeypatch.setattr(k8, "bvh_intersect_reference", lambda *a, **kw: pytest.fail("the twin ran"))
    return rec


def _chain(depth: int):
    """A BVH whose longest path holds ``depth`` nodes: each interior node
    has a leaf on its left and the rest of the chain on its right."""
    left, right = [], []
    for k in range(depth - 1):
        left.append(2 * k + 1)
        right.append(2 * k + 2)
        left.append(k_flag(k))
        right.append(1)
    left.append(k_flag(depth - 1))
    right.append(1)
    n = len(left)
    lo = np.zeros((n, 3), np.float32)
    return k8.BVH.from_arrays(lo, lo + 1, left, right, np.arange(depth) % 8)  # the 8 quads of _rays_and_quads


def k_flag(k):
    return k8.LEAF_FLAG | k


def _rays_and_quads(b: int):
    rng = np.random.default_rng(b)
    quads = make_quads(*(rng.normal(size=(8, 3)).astype(np.float32) for _ in range(3)), np.zeros(8, np.int32))
    return (torch.from_numpy(rng.normal(size=(b, 3)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(b, 3)).astype(np.float32)), quads)


@pytest.mark.parametrize("depth", [1, 5, 63])
def test_one_entry_point_call_with_the_trees_depth_plus_one_entries(lib, monkeypatch, depth):
    bvh = _chain(depth)
    assert k8.tree_depth(bvh) == depth
    o, d, quads = _rays_and_quads(37)
    depths = []
    real = k8.tree_depth
    monkeypatch.setattr(k8, "tree_depth", lambda b: depths.append(1) or real(b))
    before = k8.bvh_intersect_quads.launches
    hit, t, payload = k8.bvh_intersect_quads(bvh, quads, o, d)
    moved = bvh.to("cpu")
    k8.bvh_intersect_quads(moved, quads, o, d, torch.zeros(37))
    assert depths == [1]  # computed once, kept by to()
    assert len(lib.calls) == 2 and k8.bvh_intersect_quads.launches == before + 2
    (rows, order, n_prims, table, op, dp, t_init, b, entries, hp, tp, pp, stream) = lib.calls[0]
    assert (b, entries, stream) == (37, depth + 1, "stream")
    assert (rows, order, n_prims) == (bvh.rows.data_ptr(), bvh.prim_order.data_ptr(), depth)  # a leaf a level
    assert (op, dp, t_init) == (o.data_ptr(), d.data_ptr(), None)
    assert (hp, tp, pp) == (hit.data_ptr(), t.data_ptr(), payload.data_ptr())
    assert lib.calls[1][6] is not None and lib.calls[1][8] == depth + 1


@pytest.mark.parametrize("capacity,depth", [(k8.STACK_CAPACITY, 64), (k8.STACK_CAPACITY, 90), (4, 4), (4, 7)])
def test_a_tree_deeper_than_the_stack_is_refused(lib, monkeypatch, capacity, depth):
    monkeypatch.setattr(k8, "STACK_CAPACITY", capacity)
    bvh = _chain(depth)
    o, d, quads = _rays_and_quads(5)
    before = k8.bvh_intersect_quads.launches
    with pytest.raises(ValueError, match=f"{depth} levels deep.*holds {capacity} entries"):
        k8.bvh_intersect_quads(bvh, quads, o, d)
    assert lib.calls == [] and k8.bvh_intersect_quads.launches == before
    k8.bvh_intersect_quads(_chain(capacity - 1), quads, o, d)  # the deepest tree that fits
    assert lib.calls[0][8] == capacity


def test_the_cpu_route_walks_with_the_twin_whatever_the_depth():
    """CPU tensors run the twin, whose own stack rule (``MAX_STACK``) the
    kernel's capacity leaves as it was."""
    bvh = _chain(12)
    o, d, quads = _rays_and_quads(16)
    got = k8.bvh_intersect_quads(bvh, quads, o, d)
    want = k8.bvh_intersect_reference(bvh, o, d, k8.quad_prim_fn(quads))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
