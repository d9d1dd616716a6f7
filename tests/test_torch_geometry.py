"""Geometry primitives (``ops/geometry.py``) against the JAX package's:
``make_quads``, ``quad_hit``, ``sphere_hit``, ``aabb_intersect`` and
``face_normal`` on the same numpy inputs, made from a seed.

Gate: hit exact; t and the quad's alpha / beta (its uv under the default
texture ranges) within rtol 1e-6; the sphere's uv and normal, whose acos and
atan2 may round an ulp apart, within atol 1e-6.  The fused multiply-adds of
XLA's CPU path are checked bit for bit against :func:`fma`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.ops import geometry as jgeom
from octree_pathtracing_tpu_torch.ops import geometry

RTOL = 1e-6


def _quads_np(rng, q, ranges: bool):
    origins = rng.uniform(-2, 2, (q, 3)).astype(np.float32)
    us = rng.uniform(-1, 1, (q, 3)).astype(np.float32)
    vs = rng.uniform(-1, 1, (q, 3)).astype(np.float32)
    mats = rng.integers(0, 9, q).astype(np.int32)
    if not ranges:
        return origins, us, vs, mats
    ur = np.sort(rng.uniform(0, 1, (q, 2)), axis=1).astype(np.float32)
    vr = np.sort(rng.uniform(0, 1, (q, 2)), axis=1).astype(np.float32)
    return origins, us, vs, mats, ur, vr


def _rays(rng, b, spread=3.0):
    o = rng.uniform(-spread, spread, (b, 3)).astype(np.float32)
    d = rng.standard_normal((b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("ranges", [False, True])
def test_make_quads_matches_jax(ranges):
    args = _quads_np(np.random.default_rng(1 + ranges), 32, ranges)
    want = jgeom.make_quads(*args)
    got = geometry.make_quads(*args)
    assert got.count == want.count == 32
    for f in geometry.QuadSoA._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f == "material_id":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7, err_msg=f)


@pytest.mark.parametrize("ranges", [False, True])
def test_quad_hit_matches_jax(ranges):
    rng = np.random.default_rng(11 + ranges)
    args = _quads_np(rng, 16, ranges)
    b = 4096
    q_idx = rng.integers(0, 16, b).astype(np.int32)
    # rays toward points in and around their quads, from either side
    o, _ = _rays(rng, b)
    ab = rng.uniform(-0.2, 1.2, (b, 2)).astype(np.float32)
    target = args[0][q_idx] + ab[:, :1] * args[1][q_idx] + ab[:, 1:] * args[2][q_idx]
    d = (target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
    d = d.astype(np.float32)
    vpos = rng.uniform(-0.05, 0.05, (b, 3)).astype(np.float32)
    t_next = np.where(rng.random(b) < 0.5, np.inf, rng.uniform(0.5, 4.0, b)).astype(np.float32)
    jq = jgeom.make_quads(*args)
    want = [np.asarray(x) for x in jax.jit(jgeom.quad_hit)(jq, q_idx, o, d, vpos, t_next)]
    # the port's quads from the JAX tables: the same numbers in both
    tq = geometry.QuadSoA(*(torch.from_numpy(np.array(x)) for x in jq))
    got = [x.numpy() for x in geometry.quad_hit(tq, torch.from_numpy(q_idx), torch.from_numpy(o),
                                                torch.from_numpy(d), torch.from_numpy(vpos),
                                                torch.from_numpy(t_next))]
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].sum() > 400 and not got[0].all()
    finite = np.isfinite(want[1])
    np.testing.assert_allclose(got[1][finite], want[1][finite], rtol=RTOL)
    h = want[0]
    np.testing.assert_allclose(got[2][h], want[2][h], rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got[3][h], want[3][h], rtol=RTOL, atol=1e-7)


def test_sphere_hit_matches_jax():
    rng = np.random.default_rng(5)
    o, d = _rays(rng, 4096, spread=6.0)
    center = np.array([0.5, -0.25, 1.0], np.float32)
    radius = np.float32(2.5)
    want = [np.asarray(x) for x in jax.jit(jgeom.sphere_hit)(center, radius, o, d)]
    got = [x.numpy() for x in geometry.sphere_hit(torch.from_numpy(center), torch.tensor(radius),
                                                  torch.from_numpy(o), torch.from_numpy(d))]
    np.testing.assert_array_equal(got[0], want[0])
    assert 0.05 < got[0].mean() < 0.95
    h = want[0]
    np.testing.assert_allclose(got[1][h], want[1][h], rtol=RTOL)
    assert np.isinf(got[1][~h]).all()
    np.testing.assert_allclose(got[2][h], want[2][h], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[3][h], want[3][h], rtol=0, atol=1e-6)


def test_aabb_intersect_matches_jax():
    rng = np.random.default_rng(7)
    o, d = _rays(rng, 2048, spread=4.0)
    inv = (1.0 / d).astype(np.float32)
    lo = rng.uniform(-2, 0, (2048, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 2, (2048, 3))).astype(np.float32)
    want = [np.asarray(x) for x in jgeom.aabb_intersect(lo, hi, o, inv)]
    got = [x.numpy() for x in geometry.aabb_intersect(*(torch.from_numpy(x) for x in (lo, hi, o, inv)))]
    np.testing.assert_array_equal(got[0] <= got[1], want[0] <= want[1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL)


def test_face_normal_matches_jax():
    ids = np.array([-3, 0, 1, 2, 3, 4, 5, 9], np.int32)
    np.testing.assert_array_equal(geometry.face_normal(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jgeom.face_normal(jnp.asarray(ids))))


def test_fma_rounds_as_the_jax_cpu_path():
    """XLA's CPU path fuses a multiply into the add that takes it: a dot
    product is fma(a2, b2, fma(a1, b1, a0*b0)), ``x + y*z`` one fma.  The
    port's ``_dot`` and ``fma`` round the same way, bit for bit."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((20000, 3)).astype(np.float32)
    b = rng.standard_normal((20000, 3)).astype(np.float32)
    c = rng.standard_normal(20000).astype(np.float32)
    want_dot = np.asarray(jax.jit(lambda a, b: jnp.sum(a * b, axis=-1))(a, b))
    want_madd = np.asarray(jax.jit(lambda x, y, z: x + y * z)(c, a[:, 0], b[:, 0]))
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    np.testing.assert_array_equal(geometry._dot(ta, tb).numpy(), want_dot)
    np.testing.assert_array_equal(geometry.fma(ta[:, 0], tb[:, 0], tc).numpy(), want_madd)
    # a plain multiply-then-add rounds twice and differs on many of them
    assert ((ta[:, 0] * tb[:, 0] + tc).numpy() != want_madd).sum() > 1000
