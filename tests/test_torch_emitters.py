"""Emitter sampling against the JAX package (``models/emitters.py``):

- ``enumerate_leaves`` and ``build_emitter_table`` (pos, size, mat,
  grid_idx, grid_w) on ``emissive_room_scene(3)`` and
  ``scattered_lights_scene(5, 60)``, and the node pool of a packed table;
- ``_spatial_pick``, ``sample_emitter_point`` and ``toward_face_sample`` per
  lane on JAX-drawn uniforms (picks exact, points and pdfs within rtol 1e-6);
- the pick's pdf is exact (``test_emitters.py``'s check);
- ``EmitterSampling.ALL`` refuses more than ``ALL_MAX_EMITTERS`` emitters;
- the P1 twin (``row_gather_reference``) equals numpy's ``table[idx]``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.models import emissive_room_scene as jax_room_scene
from octree_pathtracing_tpu.models import scattered_lights_scene as jax_scattered_scene
from octree_pathtracing_tpu.models.emitters import _spatial_pick as jax_spatial_pick
from octree_pathtracing_tpu.models.emitters import sample_emitter_point as jax_sample_emitter_point
from octree_pathtracing_tpu.models.emitters import toward_face_sample as jax_toward_face_sample
from octree_pathtracing_tpu.octree.leaves import enumerate_leaves as jax_enumerate_leaves
from octree_pathtracing_tpu_torch.models import emissive_room_scene, pixel_grid_rays, scattered_lights_scene
from octree_pathtracing_tpu_torch.models.emitters import (
    ALL_MAX_EMITTERS,
    _spatial_pick,
    sample_emitter_point,
    toward_face_sample,
    with_emitter_sampling,
)
from octree_pathtracing_tpu_torch.octree import enumerate_leaves, unpack_nodes
from octree_pathtracing_tpu_torch.ops.gather import row_gather, row_gather_reference
from octree_pathtracing_tpu_torch.render import trace_paths

SCENES = {
    "room3": (lambda: jax_room_scene(depth=3), lambda: emissive_room_scene(depth=3)),
    "scattered5": (lambda: jax_scattered_scene(depth=5, n_lights=60),
                   lambda: scattered_lights_scene(depth=5, n_lights=60)),
}
TABLE_FIELDS = ("pos", "size", "mat", "grid_idx", "grid_w")


@pytest.fixture(scope="module")
def scenes():
    return {name: (jb()[0], pb()[0]) for name, (jb, pb) in SCENES.items()}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_emitter_table_equals_jax(scenes, name):
    jscene, scene = scenes[name]
    tree = jscene.octree
    got = enumerate_leaves(np.asarray(tree.child_mask), np.asarray(tree.child_data), tree.root, tree.depth)
    want = jax_enumerate_leaves(np.asarray(tree.child_mask), np.asarray(tree.child_data), tree.root, tree.depth)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the packed table's node pool enumerates the same leaves
    mask, data = unpack_nodes(scene.nodes.numpy())
    for g, w in zip(enumerate_leaves(mask, data, scene.root, scene.depth), want):
        np.testing.assert_array_equal(g, w)
    jem, em = jscene.emitters, scene.emitters
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(em, f).numpy(), np.asarray(getattr(jem, f)), err_msg=f)
    assert (em.grid_bits, em.cell_size, em.lam) == (jem.grid_bits, jem.cell_size, jem.lam)
    # the CLI's override rebuilds the same table from the packed nodes
    rebuilt = with_emitter_sampling(dataclasses.replace(scene, emitters=None), "one").emitters
    for f in TABLE_FIELDS:
        assert torch.equal(getattr(rebuilt, f), getattr(em, f)), f


def _lanes(name, scene, n=512):
    """Shading points inside the room with axis normals, and JAX-drawn
    uniforms (pick, u1, u2), as numpy."""
    rng = np.random.default_rng(len(name))
    s = float(1 << scene.depth)
    p = rng.uniform(1.0, s - 1.0, (n, 3)).astype(np.float32)
    p[: n // 2, 1] = 1.0  # half of them on the floor's top face
    nrm = np.zeros((n, 3), np.float32)
    nrm[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
    nrm[: n // 2] = (0.0, 1.0, 0.0)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (n, 3)), np.float32)
    return p, nrm, u


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_spatial_pick_and_point_sample_match_jax(scenes, name):
    jscene, scene = scenes[name]
    jem, em = jscene.emitters, scene.emitters
    p, nrm, u = _lanes(name, scene)

    idx, inv_p = _spatial_pick(em, _t(p), _t(u[:, 0]))
    j_idx, j_inv_p = jax_spatial_pick(jem, jnp.asarray(p), jnp.asarray(u[:, 0]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(inv_p.numpy(), np.asarray(j_inv_p), rtol=1e-6)

    got = sample_emitter_point(em, _t(p), _t(u[:, 0]), _t(u[:, 1]), _t(u[:, 2]), n=_t(nrm))
    want = jax_sample_emitter_point(jem, jnp.asarray(p), jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]),
                                    jnp.asarray(u[:, 2]), n=jnp.asarray(nrm))
    np.testing.assert_array_equal(got["mat"].numpy(), np.asarray(want["mat"]))
    np.testing.assert_array_equal(got["ne"].numpy(), np.asarray(want["ne"]))
    for k in ("q", "uv", "inv_pdf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6, err_msg=k)

    pos, size = em.pos[idx.long()], em.size[idx.long()]
    for axis in range(3):
        q, ne, uv = toward_face_sample(pos, size, _t(p), axis, _t(u[:, 1]), _t(u[:, 2]))
        jq, jne, juv = jax_toward_face_sample(jnp.asarray(pos.numpy()), jnp.asarray(size.numpy()),
                                              jnp.asarray(p), axis, jnp.asarray(u[:, 1]), jnp.asarray(u[:, 2]))
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ne.numpy(), np.asarray(jne))
        np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))


def test_spatial_pick_pdf_is_exact(scenes):
    """test_emitters.py's check: the mixture pdf sums to 1 over the table at
    any shading point, the sampled histogram follows it, and every sample's
    inverse pdf is the analytic one."""
    _, scene = scenes["scattered5"]
    em = scene.emitters
    e = em.count
    pts = np.random.default_rng(0).uniform(1, 31, (16, 3)).astype(np.float32)
    g = 1 << em.grid_bits
    cell = np.clip((pts / em.cell_size).astype(np.int64), 0, g - 1)
    c = (cell[:, 0] * g + cell[:, 1]) * g + cell[:, 2]
    gi, gw = em.grid_idx.numpy()[c], em.grid_w.numpy()[c]
    pdf = np.full((pts.shape[0], e), em.lam / e)
    for pi in range(pts.shape[0]):
        for j in range(gi.shape[1]):
            pdf[pi, gi[pi, j]] += (1 - em.lam) * gw[pi, j]
    np.testing.assert_allclose(pdf.sum(axis=1), 1.0, rtol=1e-5)

    n = 40000
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (n,)), np.float32)
    idx, inv_p = _spatial_pick(em, _t(np.broadcast_to(pts[3], (n, 3))), _t(u))
    idx = idx.numpy()
    np.testing.assert_allclose(np.bincount(idx, minlength=e) / n, pdf[3], atol=4.0 / np.sqrt(n))
    np.testing.assert_allclose(inv_p.numpy(), 1.0 / pdf[3, idx], rtol=1e-4)


def test_emitter_all_refuses_large_tables():
    scene, cam = emissive_room_scene(depth=4)
    assert scene.emitters.count > ALL_MAX_EMITTERS
    scene = dataclasses.replace(scene, emitter_sampling="all")
    o, d = pixel_grid_rays(cam, 4, 4)
    u = torch.rand((16, 2, 21))
    with pytest.raises(ValueError, match=f"E={scene.emitters.count} > {ALL_MAX_EMITTERS}"):
        trace_paths(scene, o, d, u)


@pytest.mark.parametrize("width,dtype", [(8, torch.int32), (8, torch.float32), (3, torch.float32)])
def test_row_gather_twin_equals_numpy(width, dtype):
    rng = np.random.default_rng(width)
    table = rng.integers(-2**31, 2**31 - 1, (300, width), dtype=np.int64).astype(np.int32)
    # negatives wrap once, as jnp indexing does; the rest clip, as XLA's gathers clip
    idx = rng.integers(-304, 304, 1000).astype(np.int32)
    t = torch.from_numpy(table).view(dtype)
    for fn in (row_gather, row_gather_reference):
        got = fn(t, torch.from_numpy(idx))
        assert got.dtype == dtype and got.shape == (1000, width)
        np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                      table[np.clip(np.where(idx < 0, idx + 300, idx), 0, 299)])
    with pytest.raises(ValueError, match="table"):
        row_gather(t.double(), torch.from_numpy(idx))
