"""The port's kernels against their plain-torch twins on a CUDA card: the
traversal in its four modes (K1, K2 alpha accept, K3r recording walk, K3s
shadow walk), P2 (Philox uniforms) and P1 (row gather), and the path
tracer's frame and gradients through the kernels against the same through
the twins, with and without light sampling.

Every test here is marked ``gpu`` and skips where there is no card.  The
file imports no jax (the machine with the card has none), so it runs there
without the repo's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from octree_pathtracing_tpu_torch.models import (
    cutout_chunk_scene,
    emissive_room_scene,
    face_normals,
    minecraft_chunk_scene,
    octree_from_grid,
    pixel_grid_rays,
)
from octree_pathtracing_tpu_torch.models import emitters
from octree_pathtracing_tpu_torch.models.sun import SunSampling, random_sun_direction
from octree_pathtracing_tpu_torch.ops.gather import row_gather, row_gather_reference
from octree_pathtracing_tpu_torch.ops.random import philox_uniforms, philox_uniforms_reference
from octree_pathtracing_tpu_torch.ops.shading import OFFSET
from octree_pathtracing_tpu_torch.ops.traversal import (
    pack_nodes,
    traverse,
    traverse_alpha,
    traverse_alpha_reference,
    traverse_record,
    traverse_record_reference,
    traverse_reference,
    traverse_shadow,
    traverse_shadow_reference,
)
from octree_pathtracing_tpu_torch.parallel import apply_params
from octree_pathtracing_tpu_torch.render import pathtracer
from octree_pathtracing_tpu_torch.render.hit import accept_tables

MAX_DIST = 1024.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels run only there)")
    return torch.device("cuda")


def _random_case(depth, n, seed, dev):
    rng = np.random.default_rng(seed)
    s = 1 << depth
    grid = (rng.random((s, s, s)) < 0.12).astype(np.uint32) * rng.integers(1, 10, (s, s, s)).astype(np.uint32)
    tree = octree_from_grid(grid)
    nodes = pack_nodes(torch.from_numpy(tree.child_mask.astype(np.int64)),
                       torch.from_numpy(tree.child_data.astype(np.int64))).to(dev)
    o = rng.uniform(-s, 2 * s, (n, 3))
    d = rng.uniform(0, s, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.from_numpy(o.astype(np.float32)).to(dev)
    d = torch.from_numpy(d.astype(np.float32)).to(dev)
    active = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    return tree, nodes, o, d, active


def _assert_equal_results(k, r):
    """Both round every operation once: equal on every lane."""
    for f in ("hit", "face_id", "leaf_value", "t", "uv", "voxel_pos", "voxel_size", "steps", "fetches"):
        assert torch.equal(getattr(k, f), getattr(r, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [3, 4, 6])
def test_kernel_matches_twin(cuda, depth):
    tree, nodes, o, d, active = _random_case(depth, 4096, 11 + depth, cuda)
    for act in (None, active):
        before = traverse.launches
        k = traverse(nodes, tree.root, tree.depth, tree.scale(), o, d, MAX_DIST, act)
        assert traverse.launches == before + 1
        r = traverse_reference(nodes, tree.root, tree.depth, tree.scale(), o, d, MAX_DIST, act)
        torch.cuda.synchronize()
        _assert_equal_results(k, r)
        assert k.hit.any()


@pytest.mark.gpu
def test_kernel_matches_twin_on_terrain_and_frame(cuda, monkeypatch):
    scene, cam = minecraft_chunk_scene(depth=7)
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 96, 64)
    o = o.contiguous()
    args = (scene.nodes, scene.root, scene.depth, scene.octree_scale, o, d, MAX_DIST, None)
    _assert_equal_results(traverse(*args), traverse_reference(*args))

    u = torch.from_numpy(np.random.default_rng(3).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)
    got = pathtracer.trace_paths(scene, o, d, u)
    monkeypatch.setattr(pathtracer, "traverse", traverse_reference)
    want = pathtracer.trace_paths(scene, o, d, u)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    assert torch.isfinite(got).all() and got.mean() > 0


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    tree, nodes, o, d, active = _random_case(3, 64, 1, cuda)
    base = (nodes, tree.root, tree.depth, tree.scale())
    with pytest.raises(ValueError, match="contiguous"):
        traverse(*base, o.t().contiguous().t(), d)
    with pytest.raises(ValueError, match="float32"):
        traverse(*base, o.double(), d)
    with pytest.raises(ValueError, match="int32"):
        traverse(nodes.long(), *base[1:], o, d)
    with pytest.raises(ValueError, match="active"):
        traverse(*base, o, d, MAX_DIST, active.int())
    with pytest.raises(ValueError, match="one device"):
        traverse(nodes.cpu(), *base[1:], o, d)


@pytest.mark.gpu
def test_empty_batch_launches_nothing(cuda):
    tree, nodes, o, d, _ = _random_case(3, 8, 2, cuda)
    before = traverse.launches
    res = traverse(nodes, tree.root, tree.depth, tree.scale(), o[:0], d[:0])
    assert traverse.launches == before
    assert res.hit.shape == (0,) and res.uv.shape == (0, 2) and int(res.steps) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536 * 5 * 21, 1001, 7])
def test_philox_kernel_matches_twin_bit_for_bit(cuda, n):
    before = philox_uniforms.launches
    got = philox_uniforms(2**40 + 3, 2**33 + 5, n, cuda)
    assert philox_uniforms.launches == before + 1
    want = philox_uniforms_reference(2**40 + 3, 2**33 + 5, n, cuda)
    torch.cuda.synchronize()
    assert got.shape == (n,) and torch.equal(got, want)
    assert philox_uniforms(0, 0, 0, cuda).shape == (0,) and philox_uniforms.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("build", [cutout_chunk_scene, minecraft_chunk_scene])
def test_accept_kernels_match_twins(cuda, build):
    scene, cam = build(depth=6)
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 96, 64)
    args = (scene.nodes, scene.root, scene.depth, scene.octree_scale, o.contiguous(), d)
    tables = accept_tables(scene)
    before = (traverse_alpha.launches, traverse_record.launches)
    _assert_equal_results(traverse_alpha(*args, tables), traverse_alpha_reference(*args, tables))
    k, k_rec = traverse_record(*args, tables)
    r, r_rec = traverse_record_reference(*args, tables)
    torch.cuda.synchronize()
    assert (traverse_alpha.launches, traverse_record.launches) == (before[0] + 1, before[1] + 1)
    _assert_equal_results(k, r)
    for f in k_rec._fields:
        assert torch.equal(getattr(k_rec, f), getattr(r_rec, f)), f
    assert (k_rec.count >= 2).any()


@pytest.mark.gpu
def test_alpha_frame_and_gradients_through_kernels_match_twins(cuda, monkeypatch):
    scene, cam = cutout_chunk_scene(depth=6)
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 48, 32)
    u = torch.from_numpy(np.random.default_rng(5).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)

    def run():
        p = {"atlas": scene.atlas.clone().requires_grad_(True),
             "emittance": scene.materials.emittance.clone().requires_grad_(True)}
        rad = pathtracer.trace_paths(apply_params(scene, p), o, d, u)
        rad.mean().backward()
        return rad.detach(), p["atlas"].grad, p["emittance"].grad

    before = traverse_alpha.launches
    got = run()
    assert traverse_alpha.launches > before
    monkeypatch.setattr(pathtracer, "traverse_alpha", traverse_alpha_reference)
    want = run()
    torch.testing.assert_close(got[0], want[0], rtol=2e-3, atol=2e-3)
    # the atlas gradient is a scatter-add whose order the card does not fix
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    assert torch.isfinite(got[1]).all() and got[1].abs().max() > 0


def _shadow_rays(scene, cam, w, h, seed):
    """Shadow rays from the primaries' hit points, offset as the path tracer
    offsets them: even lanes toward the sun, odd lanes in random directions
    of the hit face's hemisphere (these cross more surfaces).  Returns
    (origins, dirs, active, cur_mat)."""
    o, d = pixel_grid_rays(cam, w, h)
    res = pathtracer._trace(scene, o, d)
    n = face_normals(o.device)[res.face_id.clamp(0, 5).long()]
    hp = torch.where(res.hit[:, None], o + d * res.t[:, None], o)
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((o.shape[0], 2), generator=g).to(o.device)
    rnd = torch.randn((o.shape[0], 3), generator=g).to(o.device)
    rnd = rnd / rnd.norm(dim=-1, keepdim=True)
    rnd = torch.where(((rnd * n).sum(-1) < 0)[:, None], -rnd, rnd)
    sun = random_sun_direction(scene.sun, u[:, 0], u[:, 1])
    dirs = torch.where((torch.arange(o.shape[0], device=o.device) % 2 == 0)[:, None], sun, rnd)
    front = (dirs * n).sum(-1) > 0
    origins = torch.where(front[:, None], hp, hp - OFFSET * n) + dirs * OFFSET
    cur_mat = torch.randint(0, scene.materials.count, (o.shape[0],), generator=g, dtype=torch.int32)
    return origins.contiguous(), dirs.contiguous(), res.hit & front, cur_mat.to(o.device)


@pytest.mark.gpu
@pytest.mark.parametrize("build", [cutout_chunk_scene, minecraft_chunk_scene])
@pytest.mark.parametrize("strict,record_t", [(True, False), (False, True)])
def test_shadow_kernel_matches_twin(cuda, build, strict, record_t):
    scene, cam = build(depth=6)
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d, active, cur_mat = _shadow_rays(scene, cam, 96, 64, 4)
    args = (scene.nodes, scene.root, scene.depth, scene.octree_scale, o, d, accept_tables(scene),
            cur_mat, strict, record_t, 1024.0, active)
    before = traverse_shadow.launches
    k, k_st = traverse_shadow(*args)
    r, r_st = traverse_shadow_reference(*args)
    torch.cuda.synchronize()
    assert traverse_shadow.launches == before + 1
    _assert_equal_results(k, r)
    for f in k_st._fields:
        if f == "ts" and not record_t:
            assert k_st.ts is None and r_st.ts is None
            continue
        assert torch.equal(getattr(k_st, f), getattr(r_st, f)), f
    assert (k_st.count >= 1).any() and not bool(k.fetches[~active].any())


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,width,dtype", [(1 << 17, 8, torch.int32), (4096, 8, torch.float32),
                                                 (4096, 3, torch.float32)])
def test_row_gather_matches_twin_bit_for_bit(cuda, n_rows, width, dtype):
    g = torch.Generator().manual_seed(n_rows + width)
    table = torch.randint(-2**31, 2**31 - 1, (n_rows, width), generator=g, dtype=torch.int32)
    table = table.view(dtype).to(cuda)
    idx = torch.randint(-5, n_rows + 5, (65536,), generator=g, dtype=torch.int32).to(cuda)  # some clip
    before = row_gather.launches
    got = row_gather(table, idx)
    want = row_gather_reference(table, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert got.dtype == dtype and torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert row_gather(table, idx[:0]).shape == (0, width) and row_gather.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("build,sampling", [(cutout_chunk_scene, "one"), (minecraft_chunk_scene, "one"),
                                            (emissive_room_scene, "one_block")])
def test_light_sampling_frame_and_gradients_through_kernels_match_twins(cuda, monkeypatch, build, sampling):
    scene, cam = build(depth=5)
    scene = emitters.with_emitter_sampling(
        dataclasses.replace(scene, sun_sampling=SunSampling.high_quality()), sampling)
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 48, 32)
    u = torch.from_numpy(np.random.default_rng(6).random((o.shape[0], 4, 21), dtype=np.float32)).to(cuda)

    def run():
        p = {"atlas": scene.atlas.clone().requires_grad_(True),
             "emittance": scene.materials.emittance.clone().requires_grad_(True)}
        rad = pathtracer.trace_paths(apply_params(scene, p), o, d, u)
        rad.mean().backward()
        return rad.detach(), p["atlas"].grad, p["emittance"].grad

    counts = (traverse_shadow.launches, row_gather.launches)
    got = run()
    assert traverse_shadow.launches > counts[0] or scene.shadow_binary
    assert row_gather.launches > counts[1] or sampling != "one"
    for name, twin in (("traverse", traverse_reference), ("traverse_alpha", traverse_alpha_reference),
                       ("traverse_shadow", traverse_shadow_reference)):
        monkeypatch.setattr(pathtracer, name, twin)
    monkeypatch.setattr(emitters, "row_gather", row_gather_reference)
    want = run()
    torch.testing.assert_close(got[0], want[0], rtol=2e-3, atol=2e-3)
    for g, w in zip(got[1:], want[1:]):  # scatter-adds in an order the card does not fix
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    assert torch.isfinite(got[0]).all() and got[0].mean() > 0
