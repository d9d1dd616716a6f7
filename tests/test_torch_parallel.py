"""The sharded render and train step over ``torch.distributed``: two
ranks spawned on the CPU (gloo) run ``torch_sharded_rank.rank_steps``
(``sharded_render`` and ``sharded_train_step``) in both layouts, (dp = 2, sp = 1) and (dp = 1, sp = 2), on the sphere at depth 3,
8x4 lanes, S = 2 samples and 2 bounces, held against the JAX package's
unsharded ``trace_paths`` average and ``jax.value_and_grad(render_loss)``
on the same seeded inputs (the uniforms drawn with ``jax.random``): the
image within rtol and atol 1e-6 (test_sharding.py's gate), the loss and
the atlas and emittance gradients within rtol 1e-5 / atol 1e-7 and the same
on both ranks.  Also the mesh's factoring rule and the rank blocks, in one
process.  The spawn has a timeout of its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_pathtracing_tpu.models import sphere_scene as jax_sphere_scene
from octree_pathtracing_tpu.models.camera import pixel_grid_rays as jax_pixel_grid_rays
from octree_pathtracing_tpu.parallel.mesh import make_mesh as jax_make_mesh
from octree_pathtracing_tpu.parallel.shard import render_loss as jax_render_loss
from octree_pathtracing_tpu.render import draw_uniforms as jax_draw_uniforms
from octree_pathtracing_tpu.render import trace_paths as jax_trace_paths
from octree_pathtracing_tpu_torch.models.convert import scene_from_jax_arrays
from octree_pathtracing_tpu_torch.parallel import Mesh, global_ray_batch, make_mesh, mesh_shape, spawn_ranks
from torch_sharded_rank import rank_steps

S, W, H, N_BOUNCES = 2, 8, 4, 2
SPAWN_TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def run():
    """(the two ranks' results, the JAX image, loss and gradients)."""
    jscene, jcam = jax_sphere_scene(depth=3)
    o, d = jax_pixel_grid_rays(jcam, W, H)
    b = o.shape[0]
    u = jax_draw_uniforms(jax.random.PRNGKey(5), S * b, n_bounces=N_BOUNCES).reshape(S, b, N_BOUNCES, -1)
    o_s, d_s = jnp.broadcast_to(o[None], (S, b, 3)), jnp.broadcast_to(d[None], (S, b, 3))
    target = jnp.full((S, b, 3), 0.25, jnp.float32)
    trace = jax.jit(lambda u_k: jax_trace_paths(jscene, o, d, u_k, tiles=1))
    want = sum(np.asarray(trace(u[k])) for k in range(S)) / S
    params = {"atlas": jscene.atlas, "emittance": jscene.materials.emittance}
    flat = lambda x: x.reshape((S * b,) + x.shape[2:])  # noqa: E731
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_render_loss(jscene, p, flat(o_s), flat(d_s), flat(u), flat(target))))(params)
    as_t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    ranks = spawn_ranks(rank_steps, 2, "gloo",
                        (scene_from_jax_arrays(jscene), as_t(o_s), as_t(d_s), as_t(u), as_t(target), (1, 2), (1, 2),
                         "cpu"), timeout=SPAWN_TIMEOUT_S)
    return ranks, want, float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("sp", [1, 2])
def test_sharded_render_matches_unsharded_jax(run, sp):
    ranks, want, _, _ = run
    for r in ranks:
        assert r["render"][sp].shape == (W * H, 3)
        np.testing.assert_allclose(r["render"][sp], want, rtol=1e-6, atol=1e-6)
    assert want.mean() > 1e-3


@pytest.mark.parametrize("sp", [1, 2])
def test_sharded_train_step_matches_unsharded_jax(run, sp):
    ranks, _, loss, grads = run
    for r in ranks:
        got_loss, got = r["train"][sp]
        assert got_loss == pytest.approx(loss, rel=1e-5, abs=1e-7)
        for k in ("atlas", "emittance"):
            np.testing.assert_allclose(got[k], grads[k], rtol=1e-5, atol=1e-7)
    a, b = ranks[0]["train"][sp], ranks[1]["train"][sp]
    assert a[0] == b[0] and all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
    assert np.abs(grads["atlas"]).max() > 0


def test_mesh_made_again_keeps_its_sp_groups(run):
    """A mesh made again for the same sp reuses its subgroup: no step makes
    a new process group."""
    ranks, _, _, _ = run
    for r in ranks:
        assert r["same_group"] == {1: True, 2: True}


@pytest.mark.parametrize("n, want", [(1, (1, 1)), (2, (2, 1)), (3, (3, 1)), (4, (2, 2)), (8, (4, 2))])
def test_mesh_shape_factors_as_jax(n, want):
    assert mesh_shape(n) == want
    devices = jax.devices()
    if len(devices) >= n:  # the JAX mesh over n of the virtual CPU devices
        assert tuple(jax_make_mesh(n).devices.shape) == want


def test_rank_blocks_cover_the_batch_once():
    """Every (dp, sp) rank keeps its own rows; the blocks tile the batch."""
    x = np.arange(4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
    seen = np.zeros(x.shape[:2], np.int32)
    for rank in range(4):
        mesh = Mesh(dp=2, sp=2, rank=rank)
        (blk,) = global_ray_batch(mesh, (x,))
        s0, b0 = mesh.sp_index * 2, mesh.dp_index * 3
        assert torch.equal(blk, torch.from_numpy(x[s0:s0 + 2, b0:b0 + 3]))
        seen[s0:s0 + 2, b0:b0 + 3] += 1
    assert (seen == 1).all()
    assert make_mesh() == Mesh(dp=1, sp=1, rank=0)  # no process group: one rank
