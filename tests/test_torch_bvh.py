"""The BVH (``ops/bvh.py``, kernel K8's twin on the CPU) against the JAX
package's ``build_bvh`` and ``bvh_intersect`` with the ``quad_hit``
callback, on the same numpy inputs made from a seed.

Gates: the build's arrays equal; hit and payload exact; t bit for bit where
both walks test the same quad table (the JAX one carried over), within
rtol 1e-6 where each package builds its own (``make_quads``' normal and d
may round an ulp apart).  The rays include axis-parallel directions (the
1e-12 clamp of the inverse direction, with both signs of zero) and rays
that run along quad edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.ops.bvh import build_bvh as jax_build_bvh
from octree_pathtracing_tpu.ops.bvh import bvh_intersect as jax_bvh_intersect
from octree_pathtracing_tpu.ops.geometry import make_quads as jax_make_quads
from octree_pathtracing_tpu.ops.geometry import quad_hit as jax_quad_hit
from octree_pathtracing_tpu_torch.ops.bvh import (
    BVH,
    LEAF_FLAG,
    build_bvh,
    bvh_intersect_quads,
    bvh_intersect_reference,
    quad_prim_fn,
    tree_depth,
)
from octree_pathtracing_tpu_torch.ops.geometry import QuadSoA, make_quads

BVH_FIELDS = ("node_min", "node_max", "left", "right", "prim_order")


def _boxes(rng, p):
    lo = rng.uniform(0, 50, (p, 3)).astype(np.float32)
    return lo, lo + rng.uniform(0.01, 3, (p, 3)).astype(np.float32)


@pytest.mark.parametrize("p,leaf_size", [(37, 1), (37, 2), (700, 1), (700, 2)])
def test_build_equals_jax(p, leaf_size):
    lo, hi = _boxes(np.random.default_rng(p + leaf_size), p)
    want = jax_build_bvh(lo, hi, leaf_size)
    got = build_bvh(lo, hi, leaf_size)
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    # the kernel's rows hold the same numbers
    np.testing.assert_array_equal(got.rows[:, :3].numpy(), np.asarray(want.node_min))
    np.testing.assert_array_equal(got.rows[:, 4:7].numpy(), np.asarray(want.node_max))
    np.testing.assert_array_equal(got.rows[:, 3].view(torch.int32).numpy(), np.asarray(want.left))
    np.testing.assert_array_equal(got.rows[:, 7].view(torch.int32).numpy(), np.asarray(want.right))
    leaves = (got.left & LEAF_FLAG) != 0
    assert int(got.right[leaves].max()) <= leaf_size and 1 < tree_depth(got) < 64


def _grid_case():
    """test_geometry.py's case: 40 axis-aligned unit quads facing +z, 64
    rays straight down, and 32 more that run along the quads' edges."""
    rng = np.random.default_rng(0)
    q = 40
    origins = rng.uniform(0, 10, (q, 3)).astype(np.float32)
    us = np.zeros((q, 3), np.float32)
    vs = np.zeros((q, 3), np.float32)
    us[:, 0] = 1.0
    vs[:, 1] = 1.0
    ro = rng.uniform(-5, 15, (96, 3)).astype(np.float32)
    ro[:, 2] = 20.0
    edge = rng.integers(0, q, 32)
    ro[64:, :2] = origins[edge, :2] + np.where(np.arange(32)[:, None] % 2, [0.0, 0.5], [0.5, 0.0]).astype(np.float32)
    rd = np.zeros((96, 3), np.float32)
    rd[:, 2] = -1.0
    return (origins, us, vs), ro, rd


def _soup_case():
    """512 random quads and 256 rays: random directions, axis-parallel ones
    of both signs, and directions with a zero component of either sign."""
    rng = np.random.default_rng(5)
    q, b = 512, 256
    origins = rng.uniform(0, 20, (q, 3)).astype(np.float32)
    us = rng.normal(size=(q, 3)).astype(np.float32)
    vs = rng.normal(size=(q, 3)).astype(np.float32)
    ro = rng.uniform(-5, 25, (b, 3)).astype(np.float32)
    rd = rng.normal(size=(b, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[:48] = 0.0
    rd[np.arange(48), np.arange(48) % 3] = np.where(np.arange(48) % 2, 1.0, -1.0)
    rd[48:64, 0] = 0.0
    rd[64:80, 1] = -0.0
    return (origins, us, vs), ro, rd


def _build(quad_arrays):
    origins, us, vs = quad_arrays
    corners = np.stack([origins, origins + us, origins + vs, origins + us + vs])
    return corners.min(0) - 1e-4, corners.max(0) + 1e-4


@pytest.fixture(scope="module")
def cases():
    """For each case: the JAX result for t_init None and finite, the port's
    BVH, its own quads and the JAX quads carried over, and the rays."""
    out = {}
    for name, (quad_arrays, ro, rd) in (("grid40", _grid_case()), ("soup512", _soup_case())):
        lo, hi = _build(quad_arrays)
        jq = jax_make_quads(*quad_arrays, np.arange(len(lo)))
        jb = jax_build_bvh(lo, hi)

        def prim_fn(pid, o, d, t_best, jq=jq):
            ok, t, _, _ = jax_quad_hit(jq, pid, o, d, jnp.zeros_like(o), t_best)
            return ok, t, pid

        t_fin = np.random.default_rng(1).uniform(5.0, 20.0, ro.shape[0]).astype(np.float32)
        walk = jax.jit(lambda o, d, t0, jb=jb, prim_fn=prim_fn: jax_bvh_intersect(jb, o, d, prim_fn, t0))
        want = {"inf": walk(ro, rd, jnp.full(ro.shape[0], jnp.inf)), "finite": walk(ro, rd, t_fin)}
        carried = QuadSoA(*(torch.from_numpy(np.array(getattr(jq, f))) for f in QuadSoA._fields))
        out[name] = dict(want={k: tuple(np.asarray(x) for x in v) for k, v in want.items()}, t_fin=t_fin,
                         bvh=build_bvh(lo, hi), own=make_quads(*quad_arrays, np.arange(len(lo))),
                         carried=carried, ro=ro, rd=rd)
    return out


@pytest.mark.parametrize("name", ["grid40", "soup512"])
@pytest.mark.parametrize("t_init", ["inf", "finite"])
@pytest.mark.parametrize("tables", ["carried", "own"])
def test_walk_equals_jax(cases, name, t_init, tables):
    c = cases[name]
    want_hit, want_t, want_payload = c["want"][t_init]
    t0 = None if t_init == "inf" else torch.from_numpy(c["t_fin"])
    ro, rd = torch.from_numpy(c["ro"]), torch.from_numpy(c["rd"])
    before = bvh_intersect_quads.launches
    hit, t, payload = bvh_intersect_quads(c["bvh"], c[tables], ro, rd, t0)
    assert bvh_intersect_quads.launches == before  # the CPU runs the twin
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    np.testing.assert_array_equal(payload.numpy(), want_payload)
    assert payload.dtype == torch.int32 and 4 < int(hit.sum()) < hit.numel()
    if tables == "carried":
        np.testing.assert_array_equal(t.numpy(), want_t)
    else:
        np.testing.assert_allclose(t.numpy(), want_t, rtol=1e-6)
    if t0 is not None:  # a miss keeps its t_init
        np.testing.assert_array_equal(t.numpy()[~want_hit], c["t_fin"][~want_hit])


def test_walk_equals_brute_force_and_counts_its_work(cases):
    """The nearest quad of a brute-force scan over every quad, and the work
    the twin reports for the kernel's bound."""
    c = cases["soup512"]
    ro, rd = torch.from_numpy(c["ro"]), torch.from_numpy(c["rd"])
    stats = {}
    hit, t, payload = bvh_intersect_reference(c["bvh"], ro, rd, quad_prim_fn(c["own"]), stats=stats)
    fn = quad_prim_fn(c["own"])
    best_t = torch.full((ro.shape[0],), float("inf"))
    best = torch.full((ro.shape[0],), -1, dtype=torch.int32)
    for q in range(c["own"].count):
        ok, tq, _ = fn(torch.full((ro.shape[0],), q), ro, rd, best_t)
        take = ok & (tq < best_t)
        best_t, best = torch.where(take, tq, best_t), torch.where(take, q, best)
    assert torch.equal(payload, best) and torch.equal(t, best_t)
    assert stats["nodes"] > ro.shape[0] and 0 < stats["interior"] < stats["nodes"]
    assert 0 < stats["prims"] < ro.shape[0] * c["own"].count // 10  # the tree prunes


def test_bvh_from_arrays_and_to():
    lo, hi = _boxes(np.random.default_rng(3), 20)
    bvh = build_bvh(lo, hi)
    again = BVH.from_arrays(*(getattr(bvh, f).numpy() for f in BVH_FIELDS))
    moved = again.to("cpu")
    for f in BVH_FIELDS + ("rows",):
        assert torch.equal(getattr(moved, f), getattr(bvh, f)), f
    assert moved.rows.shape == (bvh.n_nodes, 8) and moved.rows.is_contiguous()


def test_quad_tables_are_dense_rows():
    """Every table of ``make_quads`` is C-ordered, the default texture
    ranges too (a broadcast (Q, 2) once came out column-ordered, which the
    kernels' wrappers refuse on the card)."""
    quads = make_quads(*_soup_case()[0], np.arange(512))
    assert all(x.is_contiguous() for x in quads), [f for f, x in zip(QuadSoA._fields, quads) if not x.is_contiguous()]
