"""The port's kernels against their plain-torch twins on a CUDA card: the
traversal in its four modes (K1, K2 alpha accept, K3r recording walk, K3s
shadow walk) and K2q (the block-model variant of modes 1-3), K7 (the
analytic-primitive scan), K8 (the BVH walk over quads), P2 (Philox
uniforms), P1 (row gather, from one table and from two), K4 (hit
resolve and shade, forward and backward, on every scene kind at 1 to
65,536 lanes and on bounce 2's whole batch, its live lanes first) and K4's
next-event half with K6 (``nee_setup``, ``nee_resolve``, ``nee_backward``,
on every light line's bounces at 1 to 65,536 lanes and bounce 2's whole
batch), both on states with ~60% of the lanes dead, K5 (the compaction of
live lanes, its backward and the final unpermute, ``csrc/compact.cu``, at 1
to 2,097,152 lanes and four live shares), also captured in a CUDA graph,
and the path tracer's frame and gradients through the kernels against the
same through the twins, with and without light sampling, block models and
primitives, and on a world read from a region file; a headline frame
replayed from a CUDA graph bit-equal to the eager one, and run with the
card's sync debug mode set to raise; K10 (the preview's shading,
``csrc/preview.cu``) bit-equal to its twin at 65,536 lanes on the three
preview scenes; two spawned ranks sharing the card through gloo for the
sharded render and train step.

Every test here is marked ``gpu`` and skips where there is no card.  The
file imports no jax (the machine with the card has none), so it runs there
without the repo's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import dataclasses
import functools
import math
import tempfile
import types

import numpy as np
import pytest
import torch

from octree_pathtracing_tpu_torch.models import (
    analytic_sphere_scene,
    cutout_chunk_scene,
    emissive_room_scene,
    face_normals,
    minecraft_chunk_scene,
    octree_from_grid,
    pixel_grid_rays,
    plant_scene,
)
from octree_pathtracing_tpu_torch.models import emitters, make_region_fixture, minecraft_scene_from_region
from octree_pathtracing_tpu_torch.models.prims import intersect_prims, intersect_prims_reference
from octree_pathtracing_tpu_torch.models.sun import SunSampling, random_sun_direction
from octree_pathtracing_tpu_torch.ops import nee as nee_mod
from octree_pathtracing_tpu_torch.ops import random as prandom
from octree_pathtracing_tpu_torch.ops.bvh import build_bvh, bvh_intersect_quads, bvh_intersect_reference, quad_prim_fn
from octree_pathtracing_tpu_torch.ops.geometry import make_quads
from octree_pathtracing_tpu_torch.ops.gather import (
    row_gather,
    row_gather_pair,
    row_gather_pair_reference,
    row_gather_reference,
)
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
    """Both round every operation alike: equal on every lane, the quad
    surfaces of K2q's mode 1 too."""
    for f in ("hit", "face_id", "leaf_value", "t", "uv", "voxel_pos", "voxel_size", "steps", "fetches"):
        assert torch.equal(getattr(k, f), getattr(r, f)), f
    assert (k.quad is None) == (r.quad is None)
    if k.quad is not None:
        for f in k.quad._fields:
            assert torch.equal(getattr(k.quad, f), getattr(r.quad, f)), f"quad.{f}"


def _plain_nee(monkeypatch):
    """The next-event half through its plain versions, differentiated by
    autograd, its walks through the traversal and K7 twins: the path the
    light lines ran before its kernels."""
    monkeypatch.setattr(pathtracer, "nee", lambda *a, **kw: nee_mod.nee_reference(*a, **kw)[0])
    for name, twin in (("traverse", traverse_reference), ("traverse_alpha", traverse_alpha_reference),
                       ("traverse_shadow", traverse_shadow_reference),
                       ("intersect_prims", intersect_prims_reference)):
        monkeypatch.setattr(nee_mod, name, twin)


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
@pytest.mark.parametrize("n", [65536 * 5 * 21, 1001, 7, 10_000_019])
def test_philox_kernel_matches_twin_bit_for_bit(cuda, n):
    if n == 10_000_019:  # the grid-stride loop ends inside a pass of the grid
        stride = prandom._library().philox_resident_blocks() * 256 * 2 * 4
        assert stride > 0 and n % stride and (n // 4) % stride
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
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_rows,width,dtype", [(1 << 17, 8, torch.int32), (4096, 8, torch.float32),
                                                 (4096, 3, torch.float32)])
def test_row_gather_matches_twin_bit_for_bit(cuda, n_rows, width, dtype, index_dtype):
    g = torch.Generator().manual_seed(n_rows + width)
    table = torch.randint(-2**31, 2**31 - 1, (n_rows, width), generator=g, dtype=torch.int32)
    table = table.view(dtype).to(cuda)
    idx = torch.randint(-5, n_rows + 5, (65536,), generator=g, dtype=torch.int32).to(index_dtype).to(cuda)
    before = row_gather.launches
    got = row_gather(table, idx)
    want = row_gather_reference(table, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert got.dtype == dtype and torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert row_gather(table, idx[:0]).shape == (0, width) and row_gather.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("width", [8, 3])
def test_row_gather_pair_matches_twin_bit_for_bit(cuda, width, index_dtype):
    """The emitter pick's shape: (4096, K) grid_idx (int32) and grid_w
    (float32), 65536 lanes' supercells, some of them clipped."""
    g = torch.Generator().manual_seed(width)
    a = torch.randint(0, 128, (4096, width), generator=g, dtype=torch.int32).to(cuda)
    b = torch.rand((4096, width), generator=g).to(cuda)
    idx = torch.randint(-5, 4096 + 5, (65536,), generator=g).to(index_dtype).to(cuda)
    before = row_gather.launches
    got = row_gather_pair(a, b, idx)
    want = row_gather_pair_reference(a, b, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1  # one launch for both tables
    for k, r, t in zip(got, want, (a, b)):
        assert k.dtype == t.dtype and torch.equal(k.view(torch.int32), r.view(torch.int32))
    assert [x.shape for x in row_gather_pair(a, b, idx[:0])] == [(0, width)] * 2
    assert row_gather.launches == before + 1


def _rays(n, s, seed, dev):
    """``n`` rays from a box around an ``s``-wide scene toward points in it."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-s, 2 * s, (n, 3))
    d = rng.uniform(0, s, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o.astype(np.float32)).to(dev), torch.from_numpy(d.astype(np.float32)).to(dev)


# the walks of one traversal body: K1, K2, K3r, K3s and K2q's three modes
WALKS = ("K1", "K2", "K3r", "K3s", "K2q mode 1", "K2q mode 2", "K2q mode 3")
_SCENES = {}


def _walk_scene(name, dev):
    """The depth-5 cutout (modes 0-3) or plant field (K2q), built once."""
    key = "plant" if name.startswith("K2q") else "cutout"
    if key not in _SCENES:
        sc = (plant_scene if key == "plant" else cutout_chunk_scene)(depth=5)[0]
        _SCENES[key] = sc
    sc = _SCENES[key].to(dev)
    return sc, accept_tables(sc)


def _walk(name, sc, tables, o, d, active=None):
    """(kernel call, twin call) of walk ``name``; each call returns
    (HitResult, record or None).  K3r takes no active mask."""
    head = (sc.nodes, sc.root, sc.depth, sc.octree_scale, o, d)
    cur = torch.zeros((o.shape[0],), dtype=torch.int32, device=o.device)
    mode = int(name[-1]) if name.startswith("K2q") else {"K1": 0, "K2": 1, "K3r": 2, "K3s": 3}[name]
    if mode == 0:
        return (lambda: (traverse(*head, MAX_DIST, active), None),
                lambda: (traverse_reference(*head, MAX_DIST, active), None))
    if mode == 1:
        return (lambda: (traverse_alpha(*head, tables, MAX_DIST, active), None),
                lambda: (traverse_alpha_reference(*head, tables, MAX_DIST, active), None))
    if mode == 2:
        return (lambda: traverse_record(*head, tables, MAX_DIST),
                lambda: traverse_record_reference(*head, tables, MAX_DIST))
    shadow = (tables, cur, True, True, MAX_DIST, active)
    return (lambda: traverse_shadow(*head, *shadow), lambda: traverse_shadow_reference(*head, *shadow))


def _same(a, b):
    """Bit for bit, NaN where both are NaN."""
    if a is None or b is None:
        return a is None and b is None
    if a.is_floating_point():
        return bool(((a == b) | (a.isnan() & b.isnan())).all()) and a.shape == b.shape
    return torch.equal(a, b)


def _assert_walks_equal(k, r):
    (kr, krec), (rr, rrec) = k, r
    _assert_equal_results(kr, rr)
    assert (krec is None) == (rrec is None)
    if krec is not None:
        for f in krec._fields:
            assert _same(getattr(krec, f), getattr(rrec, f)), f"record.{f}"


def _card_lanes(dev):
    """The card's resident thread slots (SMs x threads per SM: 270,336 on
    an H100): a batch above it cannot be in flight at once."""
    props = torch.cuda.get_device_properties(dev)
    return props.multi_processor_count * props.max_threads_per_multi_processor


def _batch(size, dev):
    lanes = _card_lanes(dev)
    return {"1": 1, "31": 31, "4072": 4072, "lanes+1": lanes + 1, "3lanes+17": 3 * lanes + 17}[size]


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["1", "31", "4072", "lanes+1", "3lanes+17"])
@pytest.mark.parametrize("name", WALKS)
def test_walk_matches_twin_at_every_batch_size(cuda, name, size):
    """Every walk against its twin on every field, ``fetches`` and the
    record included, from one ray to batches beyond the card's thread
    slots (the last block partly filled)."""
    sc, tables = _walk_scene(name, cuda)
    n = _batch(size, cuda)
    o, d = _rays(n, 1 << sc.depth, n, cuda)
    kernel, twin = _walk(name, sc, tables, o, d)
    k = kernel()
    _assert_walks_equal(k, twin())
    assert int(k[0].fetches.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w for w in WALKS if w not in ("K3r", "K2q mode 2")])
def test_walk_matches_twin_with_a_sparse_active_mask(cuda, name):
    """1% of the lanes active: the rest start as MISS, fetch nothing and
    still write their outputs."""
    sc, tables = _walk_scene(name, cuda)
    n = _batch("3lanes+17", cuda)
    o, d = _rays(n, 1 << sc.depth, 5, cuda)
    active = torch.from_numpy(np.random.default_rng(6).random(n) < 0.01).to(cuda)
    kernel, twin = _walk(name, sc, tables, o, d, active)
    k = kernel()
    _assert_walks_equal(k, twin())
    assert int((k[0].fetches[~active] != 0).sum()) == 0 and int(k[0].fetches[active].min()) > 0


def _chain_octree(depth):
    """A chain of ``depth`` nodes down the lower corner: node k's child 0 is
    node k + 1, the last one's a leaf of value 7 (the deepest tree the
    stack takes, at depth 23)."""
    mask = np.zeros(depth, np.int64)
    data = np.zeros((depth, 8), np.int64)
    mask[:] = 1
    mask[-1] |= 1 << 8
    data[:-1, 0] = np.arange(1, depth)
    data[-1, 0] = 7
    return pack_nodes(torch.from_numpy(mask), torch.from_numpy(data))


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 7, 23])
def test_walks_match_twins_at_the_depths_the_stack_takes(cuda, depth):
    """Modes 0-3 at depth 1, on the depth-7 terrain (the deepest scene these
    tests build) and on a depth-23 chain (the stack's 24 rows)."""
    if depth == 7:
        sc, cam = minecraft_chunk_scene(depth=7)
        sc, cam = sc.to(cuda), cam.to(cuda)
        tables = accept_tables(sc)
        o, d = pixel_grid_rays(cam, 96, 64)
        o, d = o.contiguous(), d.contiguous()
    else:
        tables = _walk_scene("K2", cuda)[1]
        if depth == 1:  # one node, eight leaves
            nodes = pack_nodes(torch.tensor([0xFFFF]), torch.full((1, 8), 2))
            o, d = _rays(5000, 2, 1, cuda)
        else:  # rays from near the lower corner toward the chain's one-block leaf
            nodes = _chain_octree(depth)
            o = torch.from_numpy(np.random.default_rng(2).uniform(-4, 8, (5000, 3)).astype(np.float32)).to(cuda)
            d = torch.nn.functional.normalize(0.5 - o, dim=-1).contiguous()
        sc = types.SimpleNamespace(nodes=nodes.to(cuda), root=0, depth=depth, octree_scale=2.0 ** -depth)
    for name in WALKS[:4]:
        kernel, twin = _walk(name, sc, tables, o, d)
        k = kernel()
        _assert_walks_equal(k, twin())
        assert bool(k[0].hit.any()) or bool(k[1].count.any()), name  # K3r accepts only a 4th surface


def _outputs(res):
    """The tensors of a walk's result: HitResult fields, quad and record."""
    hit, rec = res
    out = [x for x in hit[:-1]] + ([] if hit.quad is None else list(hit.quad))
    return out + ([] if rec is None else [x for x in rec if x is not None])


@pytest.mark.gpu
@pytest.mark.parametrize("name", WALKS)
def test_walk_replays_from_a_cuda_graph(cuda, name):
    """One call beyond the card's thread slots, captured once and replayed
    three times, equals the eager call each time; the outputs are spoiled
    before every replay, so a replay that left a ray unwalked would show."""
    sc, tables = _walk_scene(name, cuda)
    n = _batch("3lanes+17", cuda)
    o, d = _rays(n, 1 << sc.depth, 7, cuda)
    kernel = _walk(name, sc, tables, o, d)[0]
    eager = _outputs(kernel())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture asks
        kernel()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _outputs(kernel())
    for _ in range(3):
        for x in captured:
            x.view(torch.uint8).fill_(0xA5)
        graph.replay()
        torch.cuda.synchronize()
        for k, e in zip(captured, eager):
            assert _same(k, e)


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["31", "3lanes+17"])
@pytest.mark.parametrize("name", WALKS)
def test_one_traversal_call_is_one_launch(cuda, name, size):
    """The device work of one call, as torch.profiler records it: one
    traversal kernel and nothing else (no fill, no reduction, no memset)."""
    from torch.profiler import ProfilerActivity, profile

    sc, tables = _walk_scene(name, cuda)
    n = _batch(size, cuda)
    o, d = _rays(n, 1 << sc.depth, 8, cuda)
    kernel = _walk(name, sc, tables, o, d)[0]
    kernel()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then records no device activity at all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kernel()
            torch.cuda.synchronize()
        device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if device:
            break
    assert len(device) == 1 and "esvo_traverse" in device[0], device


@pytest.mark.gpu
def test_row_gather_wraps_negative_indices(cuda):
    """P1 and its twins take an index in [-N, -1] as index + N (jnp's
    indexing), then clip; both single and pair, int32 and int64 indices."""
    g = torch.Generator().manual_seed(12)
    n_rows = 4096
    a = torch.randint(-2**31, 2**31 - 1, (n_rows, 8), generator=g, dtype=torch.int32).to(cuda)
    b = torch.rand((n_rows, 8), generator=g).to(cuda)
    idx = torch.randint(-2 * n_rows, 2 * n_rows, (65536,), generator=g, dtype=torch.int64)
    idx[:5] = torch.tensor([-1, -n_rows, -n_rows - 1, n_rows, -2 * n_rows])
    rows = torch.where(idx < 0, idx + n_rows, idx).clamp(0, n_rows - 1).to(cuda)
    for ix in (idx.to(cuda), idx.int().to(cuda)):
        got = row_gather(a, ix)
        got_a, got_b = row_gather_pair(a, b, ix)
        torch.cuda.synchronize()
        assert torch.equal(got, a[rows]) and torch.equal(got, row_gather_reference(a, ix))
        assert torch.equal(got_a, a[rows]) and torch.equal(got_b.view(torch.int32), b[rows].view(torch.int32))


@pytest.mark.gpu
def test_kernels_replay_in_a_cuda_graph(cuda):
    """P1 (one and two tables) and P2 launch through ctypes on PyTorch's
    current stream, so a CUDA graph captures them; replays equal eager."""
    g = torch.Generator().manual_seed(9)
    a = torch.randint(0, 128, (4096, 8), generator=g, dtype=torch.int32).to(cuda)
    b = torch.rand((4096, 8), generator=g).to(cuda)
    idx = torch.randint(0, 4096, (65536,), generator=g, dtype=torch.int32).to(cuda)

    def run():
        return (row_gather(a, idx), *row_gather_pair(a, b, idx), philox_uniforms(3, 4, 100_003, cuda))

    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for x in captured:
        x.zero_()
    before = (row_gather.launches, philox_uniforms.launches)
    graph.replay()
    torch.cuda.synchronize()
    assert (row_gather.launches, philox_uniforms.launches) == before  # a replay calls no wrapper
    for k, e in zip(captured, eager):
        assert torch.equal(k.view(torch.int32), e.view(torch.int32))


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

    counts = (traverse_shadow.launches, row_gather.launches, nee_mod.nee.setup_launches,
              nee_mod.nee.backward_launches)
    got = run()
    assert traverse_shadow.launches > counts[0] or scene.shadow_binary
    # K6's pick runs inside nee_setup: P1 has left the path
    assert row_gather.launches == counts[1]
    assert nee_mod.nee.setup_launches > counts[2] and nee_mod.nee.backward_launches > counts[3]
    for name, twin in (("traverse", traverse_reference), ("traverse_alpha", traverse_alpha_reference),
                       ("traverse_shadow", traverse_shadow_reference)):
        monkeypatch.setattr(pathtracer, name, twin)
    _plain_nee(monkeypatch)
    want = run()
    torch.testing.assert_close(got[0], want[0], rtol=2e-3, atol=2e-3)
    for g, w in zip(got[1:], want[1:]):  # scatter-adds in an order the card does not fix
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    assert torch.isfinite(got[0]).all() and got[0].mean() > 0


def _model_counts():
    return (traverse_alpha.model_launches, traverse_record.model_launches, traverse_shadow.model_launches)


@pytest.mark.gpu
def test_quad_model_kernels_match_twins(cuda):
    """K2q's modes 1 and 2 on the plant field: hit, leaf, face, t, uv, the
    record rows and the accepted quads' surfaces equal bit for bit."""
    scene, cam = plant_scene(depth=5)
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 64, 64)
    args = (scene.nodes, scene.root, scene.depth, scene.octree_scale, o.contiguous(), d)
    tables = accept_tables(scene)
    before, plain = _model_counts(), (traverse_alpha.launches, traverse_record.launches)
    k = traverse_alpha(*args, tables)
    r = traverse_alpha_reference(*args, tables)
    k2, k_rec = traverse_record(*args, tables)
    r2, r_rec = traverse_record_reference(*args, tables)
    torch.cuda.synchronize()
    assert _model_counts() == (before[0] + 1, before[1] + 1, before[2])
    assert (traverse_alpha.launches, traverse_record.launches) == plain
    _assert_equal_results(k, r)
    _assert_equal_results(k2, r2)
    for f in k_rec._fields:
        assert torch.equal(getattr(k_rec, f), getattr(r_rec, f)), f
    assert k.quad.found.any() and (k.hit & ~k.quad.found).any()


@pytest.mark.gpu
@pytest.mark.parametrize("strict,record_t", [(True, False), (False, True)])
def test_quad_model_shadow_kernel_matches_twin(cuda, strict, record_t):
    scene, cam = plant_scene(depth=5)
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d, active, cur_mat = _shadow_rays(scene, cam, 64, 64, 7)
    args = (scene.nodes, scene.root, scene.depth, scene.octree_scale, o, d, accept_tables(scene),
            cur_mat, strict, record_t, 1024.0, active)
    before = _model_counts()
    k, k_st = traverse_shadow(*args)
    r, r_st = traverse_shadow_reference(*args)
    torch.cuda.synchronize()
    assert _model_counts() == (before[0], before[1], before[2] + 1)
    _assert_equal_results(k, r)
    for f in k_st._fields:
        if f == "ts" and not record_t:
            assert k_st.ts is None and r_st.ts is None
            continue
        assert torch.equal(getattr(k_st, f), getattr(r_st, f)), f
    assert (k_st.count >= 1).any()


@pytest.mark.gpu
def test_variant_without_models_launches_no_model_kernel(cuda):
    scene, cam = cutout_chunk_scene(depth=5)
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 48, 32)
    args = (scene.nodes, scene.root, scene.depth, scene.octree_scale, o.contiguous(), d)
    tables = accept_tables(scene)
    before, plain = _model_counts(), traverse_alpha.launches
    k = traverse_alpha(*args, tables)
    _assert_equal_results(k, traverse_alpha_reference(*args, tables))
    assert _model_counts() == before and traverse_alpha.launches == plain + 1 and k.quad is None


def _prim_rays(cam, w, h, seed, dev):
    """The camera's primaries, then as many random rays (some from inside
    the sphere, some toward the quad's back)."""
    o, d = pixel_grid_rays(cam, w, h)
    g = torch.Generator().manual_seed(seed)
    ro = (torch.rand((w * h, 3), generator=g) * 40.0 - 4.0).to(dev)
    rd = torch.randn((w * h, 3), generator=g).to(dev)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    return torch.cat([o, ro]).contiguous(), torch.cat([d, rd]).contiguous()


@pytest.mark.gpu
def test_prims_kernel_matches_twin(cuda):
    """K7: hit, material, t and normal equal bit for bit; uv within 1e-6
    (CUDA's acosf and atan2f may differ from PyTorch's by an ulp)."""
    scene, cam = analytic_sphere_scene(depth=5)
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d = _prim_rays(cam, 64, 64, 5, cuda)
    for t_max in (1024.0, 20.0):
        before = intersect_prims.launches
        k = intersect_prims(scene.prims, o, d, t_max)
        r = intersect_prims_reference(scene.prims, o, d, t_max)
        torch.cuda.synchronize()
        assert intersect_prims.launches == before + 1
        for name, a, b in zip(("hit", "t", "mat", "normal"), (k[0], k[1], k[2], k[4]), (r[0], r[1], r[2], r[4])):
            assert torch.equal(a, b), name
        torch.testing.assert_close(k[3], r[3], rtol=0, atol=1e-6)
        assert k[0].any() and not k[0].all()
    assert (k[2] == 3).any()  # the quad is hit too


@pytest.mark.gpu
def test_model_and_prim_kernels_launch_nothing_on_an_empty_batch(cuda):
    scene, cam = plant_scene(depth=3)
    scene = scene.to(cuda)
    o = torch.zeros((0, 3), device=cuda)
    args = (scene.nodes, scene.root, scene.depth, scene.octree_scale, o, o, accept_tables(scene))
    before = _model_counts()
    res = traverse_alpha(*args)
    assert res.hit.shape == (0,) and res.quad.uv.shape == (0, 2)
    assert traverse_record(*args)[1].mats.shape == (4, 0)
    assert _model_counts() == before
    ana, _ = analytic_sphere_scene(depth=3)
    p_before = intersect_prims.launches
    hit, t, mat, uv, n = intersect_prims(ana.prims.to(cuda), o, o, 1024.0)
    assert hit.shape == (0,) and n.shape == (0, 3) and intersect_prims.launches == p_before


@pytest.mark.gpu
@pytest.mark.parametrize("build,sun", [(plant_scene, "high_quality"), (analytic_sphere_scene, "importance"),
                                       (analytic_sphere_scene, "high_quality")])
def test_model_and_prim_frames_through_kernels_match_twins(cuda, monkeypatch, build, sun):
    scene, cam = build(depth=5)
    scene = dataclasses.replace(scene, sun_sampling=getattr(SunSampling, sun)())
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 48, 32)
    u = torch.from_numpy(np.random.default_rng(8).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)

    def run():
        p = {"atlas": scene.atlas.clone().requires_grad_(True),
             "emittance": scene.materials.emittance.clone().requires_grad_(True)}
        rad = pathtracer.trace_paths(apply_params(scene, p), o, d, u)
        rad.mean().backward()
        return rad.detach(), p["atlas"].grad, p["emittance"].grad

    from octree_pathtracing_tpu_torch.ops import shade as k4

    before, p_before, s_before = _model_counts(), intersect_prims.launches, k4.shade.launches
    got = run()
    if scene.models is not None:
        assert _model_counts()[0] > before[0] and _model_counts()[2] > before[2]
    else:  # K7's scan runs inside K4's forward and nee_setup: no K7 launch
        assert intersect_prims.launches == p_before and k4.shade.launches > s_before
    for name, twin in (("traverse", traverse_reference), ("traverse_alpha", traverse_alpha_reference),
                       ("traverse_shadow", traverse_shadow_reference),
                       ("intersect_prims", intersect_prims_reference)):
        monkeypatch.setattr(pathtracer, name, twin)
    if sun == "high_quality":
        _plain_nee(monkeypatch)
    want = run()
    torch.testing.assert_close(got[0], want[0], rtol=2e-3, atol=2e-3)
    for g, w in zip(got[1:], want[1:]):  # scatter-adds in an order the card does not fix
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    assert torch.isfinite(got[0]).all() and got[0].mean() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("t_init", [None, 12.0])
def test_bvh_kernel_matches_twin(cuda, t_init):
    """K8 on 3,000 random quads and a grid of axis-aligned ones, rays in
    random and axis-parallel directions (both signs of zero) and rays along
    quad edges: hit, t and payload bit for bit."""
    rng = np.random.default_rng(21)
    q = 3000
    o = rng.uniform(0, 40, (q, 3)).astype(np.float32)
    u = rng.normal(size=(q, 3)).astype(np.float32)
    v = rng.normal(size=(q, 3)).astype(np.float32)
    u[:500], v[:500] = [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]
    o[:500] = np.round(o[:500])
    corners = np.stack([o, o + u, o + v, o + u + v])
    bvh = build_bvh(corners.min(0) - 1e-4, corners.max(0) + 1e-4).to(cuda)
    quads = make_quads(o, u, v, np.arange(q)).to(cuda)
    n = 8192
    ro = rng.uniform(-5, 45, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[:1024] = 0.0
    rd[np.arange(1024), np.arange(1024) % 3] = np.where(np.arange(1024) % 2, 1.0, -1.0)
    rd[1024:2048, 1] = -0.0
    ro[2048:2560] = o[:512] + [0.0, 0.5, 30.0]  # down the quads' x = 0 edge
    rd[2048:2560] = [0.0, 0.0, -1.0]
    ro, rd = torch.from_numpy(ro).to(cuda), torch.from_numpy(rd).to(cuda)
    t0 = None if t_init is None else torch.full((n,), t_init, device=cuda)
    before = bvh_intersect_quads.launches
    k = bvh_intersect_quads(bvh, quads, ro, rd, t0)
    assert bvh_intersect_quads.launches == before + 1
    r = bvh_intersect_reference(bvh, ro, rd, quad_prim_fn(quads), t0)
    torch.cuda.synchronize()
    for name, a, b in zip(("hit", "t", "payload"), k, r):
        assert torch.equal(a, b), name
    assert 100 < int(k[0].sum()) < n
    empty = ro[:0]
    assert bvh_intersect_quads(bvh, quads, empty, empty)[0].shape == (0,)
    assert bvh_intersect_quads.launches == before + 1


@pytest.mark.gpu
def test_world_frame_through_kernels_matches_twins(cuda, tmp_path, monkeypatch):
    """A region file's terrain (leaves, water, glass, glowstone) under the
    HIGH_QUALITY sun with one-emitter NEE: frame and gradients through the
    kernels against the twins."""
    blocks = ["minecraft:air", "minecraft:stone", "minecraft:grass_block", "minecraft:oak_leaves",
              "minecraft:glowstone", "minecraft:water", "minecraft:glass"]
    g = np.zeros((16, 16, 16), np.uint16)  # [y, z, x]
    g[0], g[1:3], g[3] = 1, 1, 2
    g[4:7, 5:9, 5:9], g[4, 10, 3], g[3, 2:5, 10:14], g[4:6, 12:15, 2:5] = 3, 4, 5, 6
    path = tmp_path / "r.0.0.mca"
    path.write_bytes(make_region_fixture({(0, 0): {-4: (blocks, g.ravel())}}))
    scene, cam = minecraft_scene_from_region(str(path), depth=4)
    scene = emitters.with_emitter_sampling(dataclasses.replace(scene, sun_sampling=SunSampling.high_quality()), "one")
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 48, 32)
    u = torch.from_numpy(np.random.default_rng(9).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)

    def run():
        p = {"atlas": scene.atlas.clone().requires_grad_(True),
             "emittance": scene.materials.emittance.clone().requires_grad_(True)}
        rad = pathtracer.trace_paths(apply_params(scene, p), o, d, u)
        rad.mean().backward()
        return rad.detach(), p["atlas"].grad, p["emittance"].grad

    before = (traverse.launches, traverse_shadow.launches, nee_mod.nee.setup_launches, row_gather.launches)
    got = run()
    assert traverse.launches > before[0] and traverse_shadow.launches > before[1]
    assert nee_mod.nee.setup_launches > before[2] and row_gather.launches == before[3]
    for name, twin in (("traverse", traverse_reference), ("traverse_alpha", traverse_alpha_reference),
                       ("traverse_shadow", traverse_shadow_reference)):
        monkeypatch.setattr(pathtracer, name, twin)
    _plain_nee(monkeypatch)
    want = run()
    torch.testing.assert_close(got[0], want[0], rtol=2e-3, atol=2e-3)
    for gr, w in zip(got[1:], want[1:]):  # scatter-adds in an order the card does not fix
        torch.testing.assert_close(gr, w, rtol=1e-5, atol=1e-7)
    assert torch.isfinite(got[0]).all() and got[0].mean() > 0


# ---- K4, hit resolve and shade (csrc/shade.cu) against its twins

def _glossy(scene):
    """``scene`` with metal, rough and mirror-like specular materials."""
    m = scene.materials
    k = torch.arange(m.count)
    return dataclasses.replace(scene, materials=dataclasses.replace(
        m, metalness=torch.where(k % 3 == 1, 0.5, 0.0), specular=torch.where(k % 3 == 2, 0.6, 0.0),
        roughness=torch.where(k % 2 == 0, 0.3, 0.0)))


def _mixed_atlas(scene):
    """``scene`` with its atlas rebuilt as an ``Atlas`` of per-layer sizes
    (8^2, 16^2 and 32^2 layers, nearest-resampled from its own), as a
    resource pack gives it; from numpy images, without PIL."""
    from octree_pathtracing_tpu_torch.ops.texture import build_atlas

    imgs = []
    for t, layer in enumerate(scene.atlas.numpy()):
        size = (8, 16, 32)[t % 3]
        idx = np.arange(size) * layer.shape[0] // size
        texels = np.clip(layer[idx][:, idx], 0.0, 1.0)
        texels[..., :3] **= 1 / 2.2  # the colour back to sRGB; alpha stays linear
        rgba = (texels * 255).round().astype(np.uint8)
        imgs.append(rgba)
    return dataclasses.replace(scene, atlas=build_atlas(imgs, size=None))


def _k4_scene(name):
    if name == "terrain_off":
        sc, cam = minecraft_chunk_scene(depth=5)
        return dataclasses.replace(sc, sun_sampling=SunSampling.off()), cam
    if name == "terrain_glossy":
        sc, cam = minecraft_chunk_scene(depth=5)
        return _glossy(sc), cam
    if name == "room":
        return emissive_room_scene(depth=4)
    if name == "mixed_atlas_cutout":
        sc, cam = cutout_chunk_scene(depth=5)
        return _mixed_atlas(sc), cam
    if name == "world_hq":
        blocks = ["minecraft:air", "minecraft:stone", "minecraft:oak_leaves", "minecraft:water", "minecraft:glass"]
        g = np.zeros((16, 16, 16), np.uint16)  # [y, z, x]
        g[0:2], g[2:5, 6:10, 6:10], g[6:9, 3:8, 8:13], g[2, 1:5, 1:5], g[2:5, 11:14, 2:5] = 1, 1, 2, 3, 4
        with tempfile.TemporaryDirectory() as tmp:  # the scene holds nothing of the file once built
            path = f"{tmp}/r.0.0.mca"
            with open(path, "wb") as f:
                f.write(make_region_fixture({(0, 0): {-4: (blocks, g.ravel())}}))
            sc, cam = minecraft_scene_from_region(path, depth=4)
        return dataclasses.replace(sc, sun_sampling=SunSampling.high_quality()), cam
    build = {"terrain": minecraft_chunk_scene, "cutout": cutout_chunk_scene, "plant": plant_scene,
             "analytic": analytic_sphere_scene}[name.removesuffix("_d9")]
    return build(depth=9 if name.endswith("_d9") else 5)


K4_SCENES = ("terrain", "terrain_off", "terrain_glossy", "cutout", "plant", "analytic", "room",
             "mixed_atlas_cutout", "world_hq")


def _k4_calls(name, n, dev):
    """The arguments of every ``shade`` call of one 5-bounce frame over
    ``n`` lanes of ``name``'s 256x256 primaries (a seeded shuffle; a larger
    square grid where ``n`` is larger): the first is the primary bounce,
    the second bounce 2's (the whole batch, its live lanes first); the last
    bounce's with the lanes' ``idx`` eighth (the unpermute folded into its
    stores), the others without it."""
    key = ("k4", name)
    if key not in _SCENES:
        _SCENES[key] = _k4_scene(name)
    sc, cam = (x.to(dev) for x in _SCENES[key])
    side = max(256, math.isqrt(n - 1) + 1)
    o, d = pixel_grid_rays(cam, side, side)
    g = torch.Generator().manual_seed(n)
    pick = torch.randperm(o.shape[0], generator=g)[:n].to(dev)
    u = torch.from_numpy(np.random.default_rng(n).random((n, 5, 21), dtype=np.float32)).to(dev)
    calls = []
    real = pathtracer.shade

    def recording(*a):
        calls.append(a[:7] if len(a) > 7 and a[7] is None else a)
        return real(*a)

    pathtracer.shade = recording
    try:
        pathtracer.trace_paths(sc, o[pick].contiguous(), d[pick].contiguous(), u)
    finally:
        pathtracer.shade = real
    return calls


def _assert_k4_matches_twin(call, label):
    """K4's forward and backward against their twins on ``call`` under
    ``utils.timing.check_shade``'s gate (the one chip_smoke.py holds them
    to), the backward on seeded cotangents of all three outputs, so that
    every branch of it runs; the lanes that are not bit-equal printed."""
    from octree_pathtracing_tpu_torch.ops import shade as k4
    from octree_pathtracing_tpu_torch.utils.timing import check_shade

    before = (k4.shade.launches, k4.shade.backward_launches)
    b = call[1]["throughput"].shape[0]
    g = torch.Generator().manual_seed(b)
    cot = [(torch.rand((b, n), generator=g) + 0.5).to(call[1]["throughput"].device) for n in (3, 3, 4)]
    r = check_shade(call, cot, label=label)
    print(f"K4 {label}: {b} lanes; lanes not bit-equal per field {r['differ']}; outside the gate {r['outside']}")
    if b:
        assert (k4.shade.launches, k4.shade.backward_launches) == (before[0] + 1, before[1] + 1)
    return r


def _resident_slots(scene):
    """The card's resident-thread slots of K4's widest grids: SMs x resident
    blocks x threads, the larger of the forward's and the backward's (a
    batch one lane past it makes every block walk a second tile)."""
    from octree_pathtracing_tpu_torch.ops import shade as k4

    cfg = k4.launch_configs(scene, 1 << 22)
    return max(c["sms"] * c["resident_blocks_per_sm"] * c["threads"] for c in cfg.values())


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["1", "31", "4072", "65536", "65553", "slots + 1", "bounce 2"])
@pytest.mark.parametrize("name", K4_SCENES)
def test_shade_kernels_match_twins(cuda, name, size):
    if size == "slots + 1":
        key = ("k4", name)
        if key not in _SCENES:
            _SCENES[key] = _k4_scene(name)
        n = _resident_slots(_SCENES[key][0].to(cuda)) + 1
    else:
        n = 65536 if size == "bounce 2" else int(size)
    calls = _k4_calls(name, n, cuda)
    call = calls[1] if size == "bounce 2" else calls[0]
    if size == "bounce 2":  # the whole batch, K5's live lanes first (all of them live in the closed room)
        live = int(call[1]["active"].sum())
        assert not call[5] and call[1]["throughput"].shape[0] == n and bool(call[1]["active"][:live].all())
    _assert_k4_matches_twin(call, f"{name}, {size}")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["terrain_d9", "cutout_d9"])
def test_shade_kernels_match_twins_on_the_depth9_bounces(cuda, name):
    """The headline's shape: every bounce of one 65,536-lane frame."""
    for k, call in enumerate(_k4_calls(name, 65536, cuda), start=1):
        _assert_k4_matches_twin(call, f"{name}, bounce {k}")


@pytest.mark.gpu
def test_one_shade_launch_per_bounce_forward_and_backward(cuda):
    """torch.profiler over one fwd+bwd frame: one forward kernel per
    ``_shade`` call and one backward kernel per bounce, nothing else named
    after K4."""
    from torch.profiler import ProfilerActivity, profile

    from octree_pathtracing_tpu_torch.ops import shade as k4

    scene, cam = minecraft_chunk_scene(depth=5)
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 64, 64)
    u = torch.from_numpy(np.random.default_rng(4).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)
    bounces = int((pathtracer.trace_paths_census(scene, o, d, u)[1] > 0).sum())

    def step():
        p = {"atlas": scene.atlas.clone().requires_grad_(True),
             "emittance": scene.materials.emittance.clone().requires_grad_(True)}
        pathtracer.trace_paths(apply_params(scene, p), o, d, u).mean().backward()
        torch.cuda.synchronize()

    step()
    for _ in range(3):  # a profiler session now and then records no device activity at all
        before = (k4.shade.launches, k4.shade.backward_launches)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
        device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if device:
            break
    fwd = sum("shade_forward_kernel" in x for x in device)
    bwd = sum("shade_backward_kernel" in x for x in device)
    assert bounces == 5 and fwd == bwd == bounces, (fwd, bwd, bounces)
    assert (k4.shade.launches - before[0], k4.shade.backward_launches - before[1]) == (bounces, bounces)


@pytest.mark.gpu
def test_shade_refuses_what_the_kernel_does_not_take_and_raises_on_a_refused_launch(cuda, monkeypatch):
    from octree_pathtracing_tpu_torch.ops import shade as k4
    from octree_pathtracing_tpu_torch.utils.cuda_build import load_library

    scene, st, u, res, prim, is_first, may_scatter = _k4_calls("terrain", 31, cuda)[0]
    with pytest.raises(ValueError, match="throughput"):
        k4.shade(scene, dict(st, throughput=st["throughput"].double()), u, res, prim, is_first, may_scatter)
    cpu_mats = dataclasses.replace(scene.materials, roughness=scene.materials.roughness.cpu())
    with pytest.raises(ValueError, match="card"):
        k4.shade(dataclasses.replace(scene, materials=cpu_mats), st, u, res, prim, is_first, may_scatter)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        load_library("shade", ("--no-such-option",))
    refused = types.SimpleNamespace(shade_forward=lambda *a: 1, shade_error_string=lambda rc: b"invalid argument")
    monkeypatch.setattr(k4, "_library", lambda: refused)
    before = k4.shade.launches
    with pytest.raises(RuntimeError, match="shade_forward launch failed: invalid argument"):
        k4.shade(scene, st, u, res, prim, is_first, may_scatter)
    assert k4.shade.launches == before


def _padded(scene, n_mat=None, layers=None):
    """``scene`` with its material table padded to ``n_mat`` rows (copies of
    row 0, which no leaf names beyond its own) or its atlas to ``layers``
    layers (copies of layer 0): the same lanes and the same shading over
    larger tables."""
    if n_mat is not None:
        m = scene.materials
        pad = n_mat - m.count

        def grow(x):
            return torch.cat([x, x[:1].expand(pad, *x.shape[1:])])

        fields = {f.name: grow(getattr(m, f.name)) for f in dataclasses.fields(m)
                  if isinstance(getattr(m, f.name), torch.Tensor) and getattr(m, f.name).shape[:1] == (m.count,)}
        scene = dataclasses.replace(scene, materials=dataclasses.replace(m, **fields))
    if layers is not None:
        a = scene.atlas
        scene = dataclasses.replace(scene, atlas=torch.cat([a, a[:1].expand(layers - a.shape[0], *a.shape[1:])]))
    return scene


@pytest.mark.gpu
@pytest.mark.parametrize("tables", ["the terrain's", "700 materials", "100 atlas layers"])
def test_shade_kernels_on_both_sides_of_the_table_budget(cuda, tables):
    """The forward's tables in shared memory (the terrain's 6 materials) and
    above K4_TABLE_SMEM_BUDGET (700 materials: read through __ldg), and the
    backward's sums into a 100-layer atlas gradient, on the same lanes."""
    from octree_pathtracing_tpu_torch.ops import shade as k4

    for call in _k4_calls("terrain", 4072, cuda)[:2]:
        sc = {"the terrain's": call[0], "700 materials": _padded(call[0], n_mat=700),
              "100 atlas layers": _padded(call[0], layers=100)}[tables]
        route = k4.launch_configs(sc, call[1]["throughput"].shape[0])["forward"]["tables"]
        assert route == ("__ldg" if tables == "700 materials" else "shared memory")
        _assert_k4_matches_twin((sc,) + tuple(call[1:]), f"terrain, {tables} tables (read through {route})")


@pytest.mark.gpu
@pytest.mark.parametrize("layers", [None, 100])
def test_shade_backward_under_full_contention(cuda, layers):
    """Every one of 65,536 lanes reads one texel of one emitting material
    and scatters diffusely on the primary bounce, so each gradient sum takes
    65,536 terms (2,048 warp-combined atomics on one address): the backward
    within check_shade's gate, on the room's atlas and on a 100-layer one."""
    from octree_pathtracing_tpu_torch.ops import shade as k4
    from octree_pathtracing_tpu_torch.ops.shading import U_DIFFUSE

    scene, st, u, res, prim, is_first, may_scatter = _k4_calls("room", 65536, cuda)[0]
    if layers is not None:
        scene = _padded(scene, layers=layers)
    emitting = int(torch.nonzero(scene.materials.emittance > 0)[0])
    leaf = int(torch.nonzero(scene.leaf_material == emitting)[0])
    b = st["throughput"].shape[0]
    full = functools.partial(torch.full, (b,), device=cuda)
    res = res._replace(hit=full(True), t=full(1.0), face_id=full(2, dtype=torch.int32),
                       uv=torch.full((b, 2), 0.5, device=cuda), leaf_value=full(leaf, dtype=torch.int32))
    st = dict(st, active=full(True))
    u = u.clone()
    u[:, U_DIFFUSE] = 0.0
    assert is_first
    r = _assert_k4_matches_twin((scene, st, u, res, prim, is_first, may_scatter), f"full contention, {layers} layers")
    print(f"K4 backward under full contention ({layers} layers): max abs err {r['backward_err']!r}")
    assert (r["resid"].ints[:, 2] & k4.CODE_EMIT).all() and (r["resid"].ints[:, 0] == r["resid"].ints[0, 0]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["terrain", "cutout", "plant", "analytic", "room", "world_hq"])
def test_shade_no_grad_route_is_bit_equal_to_the_autograd_route(cuda, name):
    """``shade`` without a gradient (no autograd node, no residual) and with
    one (through ShadeFunction) give the same outputs bit for bit."""
    from octree_pathtracing_tpu_torch.ops import shade as k4

    for call in _k4_calls(name, 4072, cuda)[:2]:
        scene, st = call[0], call[1]
        with torch.no_grad():
            plain = k4.shade(*call)
        s = dict(st, throughput=st["throughput"].clone().requires_grad_(True))
        graded = k4.shade(scene, s, *call[2:])
        assert plain.state["throughput"].grad_fn is None and graded.state["throughput"].grad_fn is not None
        for a, b in zip(_shaded_fields(plain), _shaded_fields(graded)):
            assert torch.equal(a.view(torch.uint8), b.detach().view(torch.uint8))


def _shaded_fields(out):
    return [out.state[k] for k in out.state] + [out.albedo, out.hitpoint, out.normal, out.mat, out.diffuse_on]


@pytest.mark.gpu
def test_shade_kernels_replay_from_a_cuda_graph(cuda):
    """K4's forward (the no-grad route) and backward captured in one CUDA
    graph each; between replays their outputs are spoiled, and every
    replay writes them again equal to the eager calls'."""
    from octree_pathtracing_tpu_torch.ops import shade as k4
    from octree_pathtracing_tpu_torch.utils.timing import shade_gradients

    scene, cam = _k4_scene("terrain")
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 64, 64)
    u = torch.from_numpy(np.random.default_rng(5).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)
    bwd_args = shade_gradients(pathtracer, scene, o, d, u)[1]
    call = _k4_calls("terrain", 4072, cuda)[1]
    def gradients(d):  # the backward's own outputs (its second is the radiance cotangent, passed through)
        return [x for x in (d[0], d[2], d[3]) if x is not None]

    with torch.no_grad():
        want_f = _shaded_fields(k4.shade(*call))
        want_b = gradients(k4._backward_cuda(*bwd_args))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            k4.shade(*call)
            k4._backward_cuda(*bwd_args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got_f = _shaded_fields(k4.shade(*call))
            got_b = gradients(k4._backward_cuda(*bwd_args))
        for _ in range(3):
            for x in got_f + got_b:
                x.view(torch.uint8).fill_(0xFF)  # NaN floats, -1 ints, bytes that are no bool
            graph.replay()
            torch.cuda.synchronize()
            for a, b in zip(got_f, want_f):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(got_b, want_b):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_shade_call_is_one_forward_kernel_and_at_most_two_backward_activities(cuda):
    """torch.profiler over ten forward calls on a bounce's lanes, by each
    route, and ten backward calls: the forward's device activities are its
    kernel and nothing else, one launch a call by its counter; the
    backward's its kernel and at most one other activity (the fill) a
    call.  Fifty marker kernels open each session, and a session can drop
    activities: it counts what it recorded after the markers as an upper
    bound."""
    from torch.profiler import ProfilerActivity, profile

    from octree_pathtracing_tpu_torch.ops import shade as k4
    from octree_pathtracing_tpu_torch.utils.timing import shade_gradients

    scene, cam = _k4_scene("terrain")
    scene, cam = scene.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 64, 64)
    u = torch.from_numpy(np.random.default_rng(6).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)
    bwd_calls = shade_gradients(pathtracer, scene, o, d, u)
    marker = torch.zeros(1, device=cuda)

    def activities(fn, calls=10):
        """(the device activities of ``calls`` calls of ``fn`` after the
        markers, the calls of ``fn`` made in all)."""
        fn()
        made = 1
        for _ in range(3):  # a profiler session now and then records no device activity at all
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    marker.sin_()
                torch.cuda.synchronize()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            made += calls
            events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
            names = [e.name for e in events if "sin" not in e.name]
            if names:
                break
        return names, made

    for k, call in enumerate(_k4_calls("terrain", 4072, cuda)[:2]):
        s = dict(call[1], throughput=call[1]["throughput"].clone().requires_grad_(True))
        for route in (lambda: k4.shade(*call), lambda: k4.shade(call[0], s, *call[2:])):
            before = k4.shade.launches
            names, made = activities(route)
            assert k4.shade.launches - before == made
            # the terrain has no primitives: the variant without K7's scan
            assert names and set(names) == {"void shade_forward_kernel<false>(ForwardParams)"} and len(names) <= 10, \
                names
        before = k4.shade.backward_launches
        names, made = activities(lambda: k4._backward_cuda(*bwd_calls[k]))
        assert k4.shade.backward_launches - before == made
        kernels = sum("shade_backward_kernel" in x for x in names)
        assert 1 <= kernels <= 10 and len(names) - kernels <= 10, names


# ---- K4's next-event half and K6 (csrc/nee.cu) against their plain versions

def _nee_scene(name):
    """The light lines at depth 5 (the world at 4, the room at 3 and 4)."""
    hq = SunSampling.high_quality()
    if name == "room_all":
        return emitters.with_emitter_sampling(emissive_room_scene(depth=3)[0], "all"), emissive_room_scene(depth=3)[1]
    if name == "room_one_block":
        sc, cam = emissive_room_scene(depth=4)
        return emitters.with_emitter_sampling(sc, "one_block"), cam
    if name == "world":
        sc, cam = _k4_scene("world_hq")
        return emitters.with_emitter_sampling(sc, "one"), cam
    if name in ("config3_nogrid", "config3_k7", "room_k64"):
        # config 3's 8 emitters with no grid (the uniform pick) or rows of 7
        # (not a multiple of 4); the room's 64 under ONE with rows of all 64
        if name == "room_k64":
            sc, cam = emissive_room_scene(depth=3)
            sc = emitters.with_emitter_sampling(dataclasses.replace(sc, sun_sampling=hq), "one")
        else:
            sc, cam = _nee_scene("config3")
        em = sc.emitters
        if name == "config3_nogrid":
            return dataclasses.replace(sc, emitters=dataclasses.replace(em, grid_idx=None, grid_w=None)), cam
        k = int(name.rsplit("_k", 1)[1])
        gi, gw = emitters.build_spatial_grid(em.pos.numpy(), em.size.numpy(), float(1 << sc.depth), em.grid_bits, k=k)
        assert gi.shape[1] == k
        return dataclasses.replace(sc, emitters=dataclasses.replace(em, grid_idx=torch.from_numpy(gi),
                                                                    grid_w=torch.from_numpy(gw))), cam
    build = {"nee": minecraft_chunk_scene, "fast": minecraft_chunk_scene, "config3": minecraft_chunk_scene,
             "cutout": cutout_chunk_scene, "cutout_lenient": cutout_chunk_scene, "plant": plant_scene,
             "analytic_hq": analytic_sphere_scene}[name]
    sc, cam = build(depth=5)
    sun = {"fast": SunSampling.fast(), "cutout_lenient": dataclasses.replace(hq, strict_direct_light=False)}.get(name, hq)
    return emitters.with_emitter_sampling(dataclasses.replace(sc, sun_sampling=sun),
                                          "one" if name in ("config3", "cutout_lenient") else "none"), cam


NEE_SCENES = ("nee", "fast", "cutout", "cutout_lenient", "config3", "plant", "analytic_hq", "world",
              "room_one_block", "room_all")


def _nee_calls(name, n, dev):
    """Every next-event call of one 5-bounce fwd+bwd frame over ``n`` lanes
    of ``name``'s 256x256 primaries (a seeded shuffle), each with the radiance
    cotangent its backward received; the room's rays go every way."""
    from octree_pathtracing_tpu_torch.utils.timing import nee_calls

    key = ("nee", name)
    if key not in _SCENES:
        _SCENES[key] = _nee_scene(name)
    sc, cam = (x.to(dev) for x in _SCENES[key])
    o, d = pixel_grid_rays(cam, 256, 256)
    g = torch.Generator().manual_seed(n)
    pick = torch.randperm(o.shape[0], generator=g)[:n].to(dev)
    o, d = o[pick].contiguous(), d[pick].contiguous()
    if name.startswith("room"):
        d = torch.randn(d.shape, generator=g).to(dev)
        d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    u = torch.from_numpy(np.random.default_rng(n).random((n, 5, 21), dtype=np.float32)).to(dev)
    return nee_calls(pathtracer, sc, o, d, u)


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["1", "31", "65536", "bounce 2"])
@pytest.mark.parametrize("name", NEE_SCENES)
def test_nee_kernels_match_plain_versions(cuda, name, size):
    """``nee_setup``, ``nee_resolve`` and ``nee_backward`` against their plain
    versions under ``utils.timing.check_nee``'s gate (the one chip_smoke.py
    holds them to): every ray field, the radiance and the residual bit-equal
    on all but 0.1% of the rows and within rtol 1e-5 / atol 1e-6; the
    backward, on the cotangent the frame's backward handed the bounce,
    within rtol 1e-5 / atol 1e-7.  The rows not bit-equal are printed."""
    from octree_pathtracing_tpu_torch.utils.timing import check_nee

    n = 65536 if size == "bounce 2" else int(size)
    calls = _nee_calls(name, n, cuda)
    call = calls[1] if size == "bounce 2" else calls[0]
    b = call[1]["throughput"].shape[0]
    if size == "bounce 2":  # the whole batch, K5's live lanes first (all of them live in the closed room)
        assert b == n and int(call[1]["active"].sum()) > 0
    before = (nee_mod.nee.setup_launches, nee_mod.nee.resolve_launches, nee_mod.nee.backward_launches)
    r = check_nee(call[:4], call[4], label=f"{name}, {size}")
    print(f"nee {name} {size}: {b} lanes x {nee_mod.nee_plan(call[0]).faces} faces, {int(r['rays'].active.sum())} "
          f"cast; rows not bit-equal setup {r['setup']['differ']}, resolve {r['resolve']['differ']}, residual "
          f"{r['resolve']['residual']['differ']}; backward max abs err {r['backward_err']!r}")
    after = (nee_mod.nee.setup_launches, nee_mod.nee.resolve_launches, nee_mod.nee.backward_launches)
    assert after == tuple(x + (1 if b else 0) for x in before)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nee", "cutout", "config3"])
def test_nee_kernels_match_plain_versions_on_the_depth9_bounces(cuda, name):
    """The light lines' shape: every bounce of one 65,536-lane depth-9 frame."""
    from octree_pathtracing_tpu_torch.utils.timing import check_nee, nee_calls

    sc, cam = (cutout_chunk_scene if name == "cutout" else minecraft_chunk_scene)(depth=9)
    sc = emitters.with_emitter_sampling(dataclasses.replace(sc, sun_sampling=SunSampling.high_quality()),
                                        "one" if name == "config3" else "none")
    sc, cam = sc.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 256, 256)
    u = pathtracer.draw_uniforms(1, 0, 256 * 256, 5, cuda)
    for k, call in enumerate(nee_calls(pathtracer, sc, o, d, u), start=1):
        r = check_nee(call[:4], call[4], label=f"{name} depth 9, bounce {k}")
        print(f"nee {name} depth 9 bounce {k}: rows not bit-equal setup {r['setup']['not_bit_equal']}, resolve "
              f"{r['resolve']['not_bit_equal']}; backward max abs err {r['backward_err']!r}")


@pytest.mark.gpu
def test_one_nee_launch_each_per_bounce(cuda):
    """torch.profiler over one fwd+bwd frame of the cutout under the
    HIGH_QUALITY sun and one-emitter NEE: one ``nee_setup`` and one
    ``nee_resolve`` kernel per ``_shade`` call, one ``nee_backward`` per
    bounce, one shadow walk per bounce for the sun and emitter faces
    together, and no P1."""
    from torch.profiler import ProfilerActivity, profile

    sc, cam = cutout_chunk_scene(depth=5)
    sc = emitters.with_emitter_sampling(dataclasses.replace(sc, sun_sampling=SunSampling.high_quality()), "one")
    sc, cam = sc.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 64, 64)
    u = torch.from_numpy(np.random.default_rng(4).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)
    bounces = int((pathtracer.trace_paths_census(sc, o, d, u)[1] > 0).sum())

    def step():
        p = {"atlas": sc.atlas.clone().requires_grad_(True),
             "emittance": sc.materials.emittance.clone().requires_grad_(True)}
        pathtracer.trace_paths(apply_params(sc, p), o, d, u).mean().backward()
        torch.cuda.synchronize()

    step()
    for _ in range(3):  # a profiler session now and then records no device activity at all
        before = (nee_mod.nee.setup_launches, nee_mod.nee.resolve_launches, nee_mod.nee.backward_launches,
                  traverse_shadow.launches, row_gather.launches)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
        device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if device:
            break
    counted = [sum(f"{k}_kernel" in x for x in device) for k in ("nee_setup", "nee_resolve", "nee_backward")]
    assert bounces == 5 and counted == [bounces] * 3, (counted, bounces)
    after = (nee_mod.nee.setup_launches, nee_mod.nee.resolve_launches, nee_mod.nee.backward_launches,
             traverse_shadow.launches, row_gather.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (bounces, bounces, bounces, bounces, 0)


@pytest.mark.gpu
def test_nee_refuses_what_the_kernels_do_not_take_and_raises_on_a_refused_launch(cuda, monkeypatch):
    from octree_pathtracing_tpu_torch.utils.cuda_build import load_library

    scene, st, u, out, _ = _nee_calls("config3", 31, cuda)[0]
    with pytest.raises(ValueError, match="throughput"):
        nee_mod.nee(scene, dict(st, throughput=st["throughput"].double()), u, out)
    cpu_mats = dataclasses.replace(scene.materials, ior=scene.materials.ior.cpu())
    with pytest.raises(ValueError, match="card"):
        nee_mod.nee(dataclasses.replace(scene, materials=cpu_mats), st, u, out)
    sun = dataclasses.replace(scene.sun, su=scene.sun.su.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="sun.su"):
        nee_mod.nee(dataclasses.replace(scene, sun=sun), st, u, out)
    room = emitters.with_emitter_sampling(emissive_room_scene(depth=4)[0], "all").to(cuda)
    with pytest.raises(ValueError, match="E=256 > 64"):
        nee_mod.nee(room, st, u, out)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        load_library("nee", ("--no-such-option",))
    refused = types.SimpleNamespace(nee_setup=lambda *a: 1, nee_error_string=lambda rc: b"invalid argument")
    monkeypatch.setattr(nee_mod, "_library", lambda: refused)
    before = nee_mod.nee.setup_launches
    with pytest.raises(RuntimeError, match="nee_setup launch failed: invalid argument"):
        nee_mod.nee(scene, st, u, out)
    assert nee_mod.nee.setup_launches == before


@pytest.mark.gpu
def test_nee_build_reports_registers_stack_and_spills(cuda):
    """A fresh build of ``csrc/nee.cu`` (a macro in the flags gives it a
    library of its own) and ptxas's report of each of its three kernels."""
    from octree_pathtracing_tpu_torch.utils.cuda_build import load_library

    lib = load_library("nee", ("-fmad=false", "-DNEE_PTXAS_REPORT"))
    log = lib.build_info["log"]
    lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln or "Compiling" in ln]
    print("\n".join(lines))
    for kernel in ("nee_setup_kernel", "nee_resolve_kernel", "nee_backward_kernel"):
        assert any(kernel in ln for ln in lines) or lib.build_info["seconds"] == 0.0, kernel


# ---- nee_setup at sizes around the card's grids on every kind of row, and
# nee_backward's one cooperative launch: contention, its scratch, a frame
# replayed from a CUDA graph

# (scene, lane order): the light lines' kinds, config 3's emitters with no
# grid and with rows of 7 entries (not a multiple of 4), the room's with
# rows of 64; shuffled lanes mostly sit in different supercells, lanes in
# pixel order share them
SETUP_CASES = tuple((name, "shuffled") for name in NEE_SCENES + ("config3_nogrid", "config3_k7", "room_k64")) + tuple(
    (name, "pixels") for name in ("config3", "config3_k7", "room_k64", "world"))


def _backward_slots(dev):
    """The card's resident-thread slots of ``nee_backward``'s cooperative
    grid (SMs x resident blocks x threads): a batch one lane past it makes a
    block take a second round of lanes."""
    with torch.cuda.device(dev):
        c = nee_mod.backward_config(1 << 22, (6, 16, 16, 4), 8)
    return c["sms"] * c["resident_blocks_per_sm"] * c["threads"]


def _forward_nee_calls(name, n, order, dev):
    """The next-event calls (scene, st, u, out) of one 5-bounce forward frame
    over ``n`` primary rays of ``name`` (the first ``n`` pixels of a square
    grid, or a seeded shuffle of them): bounce 1's, then bounce 2's whole
    batch with its dead lanes."""
    key = ("nee", name)
    if key not in _SCENES:
        _SCENES[key] = _nee_scene(name)
    sc, cam = (x.to(dev) for x in _SCENES[key])
    side = max(256, math.isqrt(n - 1) + 1)
    o, d = pixel_grid_rays(cam, side, side)
    if order == "shuffled":
        pick = torch.randperm(o.shape[0], generator=torch.Generator().manual_seed(n))[:n].to(dev)
    else:
        pick = torch.arange(n, device=dev)
    o, d = o[pick].contiguous(), d[pick].contiguous()
    if name.startswith("room"):
        d = torch.randn(d.shape, generator=torch.Generator().manual_seed(n)).to(dev)
        d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    u = torch.from_numpy(np.random.default_rng(n).random((n, 5, 21), dtype=np.float32)).to(dev)
    calls, real = [], pathtracer.nee

    def recording(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    pathtracer.nee = recording
    try:
        with torch.no_grad():
            pathtracer.trace_paths(sc, o, d, u)
    finally:
        pathtracer.nee = real
    return calls[:2]


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["1", "65553", "slots + 1"])
@pytest.mark.parametrize("name,order", SETUP_CASES)
def test_nee_setup_is_bit_equal_to_its_plain_version(cuda, name, order, size):
    """``nee_setup`` against ``nee_setup_reference`` on every ray field, bit
    for bit on every row (NaN equal to NaN), on bounce 1's lanes and bounce
    2's whole batch (its dead lanes included): the sun face, K6's pick from
    rows of 8, 7 and 64 entries or with no grid, lanes that share a
    supercell and lanes that do not, ONE_BLOCK and ALL; 1 lane, 65,553
    lanes and one past the backward's resident-thread slots."""
    from octree_pathtracing_tpu_torch.utils.timing import _bits_differ

    n = _backward_slots(cuda) + 1 if size == "slots + 1" else int(size)
    for bounce, (scene, st, u, out) in enumerate(_forward_nee_calls(name, n, order, cuda), start=1):
        plan = nee_mod.nee_plan(scene)
        c = nee_mod._Call(scene, plan, st["cur_mat"], u, out.hitpoint, out.normal, out.mat, out.diffuse_on)
        before = nee_mod.nee.setup_launches
        got = nee_mod._setup_cuda(c)
        want = nee_mod.nee_setup_reference(scene, plan, *c[2:])
        assert nee_mod.nee.setup_launches == before + 1
        differ = {f: int(_bits_differ(getattr(got, f).reshape(plan.faces * n, -1),
                                      getattr(want, f).reshape(plan.faces * n, -1)).sum())
                  for f in nee_mod.NeeRays._fields if getattr(want, f) is not None}  # K7's slots: their own test
        print(f"nee_setup {name} {order} {size} bounce {bounce}: {n} lanes x {plan.faces} faces, "
              f"{int(got.active.sum())} cast, rows not bit-equal {differ}")
        assert not any(differ.values()), (bounce, differ)


def _contended_residual(plan, b, texel, e_texel, e_mat, dev, seed):
    """A residual in which every face of every lane is cast, every sun face
    blocked by ``texel`` in its first slot (a strict zero on a tenth of
    them) and every emitter face unblocked on ``e_texel`` and ``e_mat``:
    every lane's sums land on one texel or one material."""
    g = torch.Generator().manual_seed(seed)
    ints = torch.full((plan.faces, b, nee_mod.RESID_INTS), -1, dtype=torch.int32)
    zero = (torch.rand((plan.faces, b), generator=g) < 0.1).to(torch.int32)
    first_em = 1 if plan.sun else 0
    ints[..., 0] = nee_mod.CODE_ON
    ints[:first_em, :, 0] |= zero[:first_em] << nee_mod.ZERO_SHIFT
    ints[:first_em, :, 1] = texel
    ints[first_em:, :, -2] = e_texel
    ints[first_em:, :, -1] = e_mat
    scale = torch.rand((plan.faces, b), generator=g) + 0.5
    return nee_mod.NeeResidual(ints.to(dev), scale.to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["65536", "slots + 1"])
@pytest.mark.parametrize("name", ["config3", "room_all"])
def test_nee_backward_under_full_contention(cuda, name, size):
    """Every lane's every face on one blocker texel and one emitter texel and
    material (the room under ALL: 192 faces a lane onto one material):
    ``nee_backward`` within rtol 1e-5 / atol 1e-7 of
    ``nee_backward_reference``, its scratch left zero."""
    key = ("nee", name)
    if key not in _SCENES:
        _SCENES[key] = _nee_scene(name)
    scene = _SCENES[key][0].to(cuda)
    plan = nee_mod.nee_plan(scene)
    b = _backward_slots(cuda) + 1 if size == "slots + 1" else int(size)
    g = torch.Generator().manual_seed(b)
    atlas = scene.atlas.data if hasattr(scene.atlas, "sizes") else scene.atlas
    em = scene.emitters
    e_mat = int(em.mat[0])  # the emitter face's texel: one of its material's layer
    e_texel = int(scene.materials.texture_index[e_mat]) * int(atlas.shape[1] * atlas.shape[2]) + 3
    resid = _contended_residual(plan, b, 5, e_texel, e_mat, cuda, b)
    albedo = torch.rand((b, 4), generator=g).to(cuda)
    tp = (torch.rand((b, 3), generator=g) + 0.5).to(cuda)
    cot = (torch.rand((b, 3), generator=g) - 0.5).to(cuda)
    args = (albedo, tp, resid, atlas, scene.materials.emittance, scene.sun.emittance, plan, cot,
            (True, True, True, True, True))
    before = nee_mod.nee.backward_launches
    got = nee_mod._backward_cuda(*args)
    torch.cuda.synchronize()
    assert nee_mod.nee.backward_launches == before + 1
    want = nee_mod.nee_backward_reference(*args)
    for label, x, y in zip(("throughput", "radiance", "albedo", "atlas", "emittance"), got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7, msg=lambda m, label=label: f"{label}: {m}")
        print(f"nee_backward {name} {size}, full contention: {label} max abs err {float((x - y).abs().max())!r}")
    assert float(want[3].abs().max()) > 0 and float(want[4].abs().max()) > 0
    assert bool((nee_mod._SCRATCH[cuda.index or 0][-1] == 0).all())


@pytest.mark.gpu
def test_nee_backward_scratch_is_left_zero_across_calls_sizes_and_replays(cuda):
    """Calls of three batch sizes and each mix of wanted table gradients,
    eager and then captured in one CUDA graph and replayed with their
    outputs spoiled between replays: each equal to the plain version, and
    the card's scratch all zero after every call and every replay (no fill
    between them)."""
    scene = _nee_scene("config3")[0].to(cuda)
    plan = nee_mod.nee_plan(scene)
    atlas = scene.atlas
    emit = scene.materials.emittance
    cases = []
    for b, need in ((65536, (True, True, True, True, True)), (_backward_slots(cuda) + 1, (False, True, True, True, False)),
                    (300, (True, False, False, False, True)), (1, (True, True, True, True, True))):
        g = torch.Generator().manual_seed(b)
        resid = _contended_residual(plan, b, 7, 11, int(scene.emitters.mat[1]), cuda, b)
        ints = resid.ints.clone()
        ints[..., 1] = torch.randint(-1, atlas.numel() // 4, ints.shape[:2], generator=g).to(cuda)
        resid = nee_mod.NeeResidual(ints, resid.scale)
        cases.append((torch.rand((b, 4), generator=g).to(cuda), (torch.rand((b, 3), generator=g) + 0.5).to(cuda),
                      resid, atlas, emit, scene.sun.emittance, plan, (torch.rand((b, 3), generator=g) - 0.5).to(cuda),
                      need))
    want = [nee_mod.nee_backward_reference(*a) for a in cases]

    def check(got):
        torch.cuda.synchronize()
        assert bool((nee_mod._SCRATCH[cuda.index or 0][-1] == 0).all())
        for gg, ww in zip(got, want):
            for x, y in zip(gg, ww):
                assert (x is None) == (y is None)
                if x is not None:
                    torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)

    for _ in range(2):
        check([nee_mod._backward_cuda(*a) for a in cases])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [nee_mod._backward_cuda(*a) for a in cases]
    for _ in range(3):
        for o in outs:
            for x in o:
                if x is not None and x.dtype == torch.float32 and x.data_ptr() not in {a[7].data_ptr() for a in cases}:
                    x.fill_(float("nan"))
        graph.replay()
        check(outs)


def _profiled(fn):
    """The device activities torch.profiler records over ``fn()``.  A
    session can miss the first activities after it starts, so a few spin
    kernels run first, and are left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(10000)
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [x for x in names if "spin" not in x.lower()]


@pytest.mark.gpu
def test_one_nee_backward_activity_per_light_bounce_and_no_fill_or_copy(cuda):
    """torch.profiler over a fwd+bwd frame's backward, on the cutout under the
    HIGH_QUALITY sun and one-emitter NEE and on the same frame with no light
    sampling: one ``nee_backward_kernel`` per bounce, and the same fills and
    copies in both (the next-event backward adds none); ``_backward_cuda``
    alone is one device activity."""
    from octree_pathtracing_tpu_torch.utils.timing import profiled_names

    sc, cam = cutout_chunk_scene(depth=5)
    sc, cam = sc.to(cuda), cam.to(cuda)
    light = emitters.with_emitter_sampling(dataclasses.replace(sc, sun_sampling=SunSampling.high_quality()), "one")
    plain = dataclasses.replace(light, sun_sampling=dataclasses.replace(light.sun_sampling, sun_sampling=False),
                                emitter_sampling="none")
    assert nee_mod.nee_plan(plain) is None
    o, d = pixel_grid_rays(cam, 64, 64)
    u = torch.from_numpy(np.random.default_rng(4).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)

    def backward_activities(scene):
        def loss():
            p = {"atlas": scene.atlas.clone().requires_grad_(True),
                 "emittance": scene.materials.emittance.clone().requires_grad_(True)}
            return pathtracer.trace_paths(apply_params(scene, p), o, d, u).mean()

        loss().backward()
        best = []
        for _ in range(5):  # a profiler session can drop activities: the fullest counts
            losses = [loss(), loss()]
            torch.cuda.synchronize()
            # the second of two backwards in one session (a session can drop the first activities of the first)
            names = profiled_names(lambda: (losses.pop(0).backward(), torch.cuda.synchronize()))
            if len(names) > len(best):
                best = names
        low = [x.lower() for x in best]
        return {"nee_backward": sum("nee_backward_kernel" in x for x in best),
                "fills": sum("fill" in x or "memset" in x for x in low),
                "copies": sum("copy" in x or "memcpy" in x for x in low), "all": len(best)}

    with_nee, without = backward_activities(light), backward_activities(plain)
    print(f"fwd+bwd frame's backward, device activities: with NEE {with_nee}, without {without}")
    assert with_nee["nee_backward"] == 5 and without["nee_backward"] == 0
    assert (with_nee["fills"], with_nee["copies"]) == (without["fills"], without["copies"])
    # the call alone
    from octree_pathtracing_tpu_torch.utils.timing import check_nee, nee_calls

    call = nee_calls(pathtracer, light, o, d, u)[0]
    args = check_nee(call[:4], call[4], "the cutout's bounce 1")["args"]["backward"]
    nee_mod._backward_cuda(*args)
    torch.cuda.synchronize()
    for _ in range(5):
        names = _profiled(lambda: nee_mod._backward_cuda(*args))
        if names:
            break
    assert len(names) == 1 and "nee_backward_kernel" in names[0], names


@pytest.mark.gpu
@pytest.mark.parametrize("sampling", ["none", "one"])
def test_light_line_fwd_bwd_frame_replays_from_a_cuda_graph(cuda, sampling):
    """A light line's whole fwd+bwd frame (the cutout under the HIGH_QUALITY
    sun, with and without one-emitter NEE) captured in one CUDA graph:
    each replay, with the radiance and the gradients spoiled before it,
    gives the eager frame's radiance bit for bit and its atlas and
    emittance gradients within rtol 1e-5 / atol 1e-7 (float atomics add in
    the schedule's order)."""
    sc, cam = cutout_chunk_scene(depth=5)
    scene = emitters.with_emitter_sampling(dataclasses.replace(sc.to(cuda), sun_sampling=SunSampling.high_quality()),
                                           sampling)
    o, d = pixel_grid_rays(cam.to(cuda), 64, 64)
    u = torch.from_numpy(np.random.default_rng(5).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)
    p = {"atlas": scene.atlas.clone().requires_grad_(True),
         "emittance": scene.materials.emittance.clone().requires_grad_(True)}

    def step():
        rad = pathtracer.trace_paths(apply_params(scene, p), o, d, u)
        rad.mean().backward()
        return rad

    eager = step().detach().clone()
    grads = {k: v.grad.clone() for k, v in p.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture asks
        for _ in range(2):
            for v in p.values():
                v.grad = None
            step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for v in p.values():
        v.grad = None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rad = step()
    for _ in range(3):
        rad.detach().fill_(float("nan"))
        for v in p.values():
            v.grad.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(rad.detach(), eager)
        for k, v in p.items():
            torch.testing.assert_close(v.grad, grads[k], rtol=1e-5, atol=1e-7)
    assert float(grads["atlas"].abs().max()) > 0


# ---- dead lanes through K4 and its next-event half: since K5 compacts
# without shrinking the batch, every bounce after the first hands them
# its dead lanes

def _dead(call, seed):
    """``call`` (a recorded ``shade`` call) on a later bounce with ~60% of
    its lanes dead (seeded), traversed as the bounce loop traverses it."""
    scene, st = call[0], call[1]
    g = torch.Generator().manual_seed(seed)
    live = (torch.rand(st["active"].shape, generator=g) >= 0.6).to(st["active"].device)
    st = dict(st, active=st["active"] & live)
    res = pathtracer._trace(scene, st["origin"], st["dir"], st["active"])
    prim = pathtracer._prim_hit(scene, st["origin"], st["dir"]) if scene.prims is not None else None
    return (scene, st, call[2], res, prim, False, True)


@pytest.mark.gpu
@pytest.mark.parametrize("name", K4_SCENES)
def test_shade_kernels_pass_dead_lanes_through(cuda, name):
    """K4's kernels against their twins on a state with ~60% dead lanes,
    under ``check_shade``'s gate; the kernel leaves a dead lane's state bit
    for bit as it was, passes its throughput and radiance cotangents
    through, and adds nothing to the atlas or the emittance from it."""
    from octree_pathtracing_tpu_torch.ops import shade as k4

    call = _dead(_k4_calls(name, 4072, cuda)[0], 7)
    dead = ~call[1]["active"]
    assert 0.5 < float(dead.float().mean()) < 0.7
    r = _assert_k4_matches_twin(call, f"{name}, 60% dead")
    out = r["out"]
    for k, v in out.state.items():
        assert torch.equal(v[dead].view(torch.uint8), call[1][k][dead].view(torch.uint8)), k
    assert not bool(out.diffuse_on[dead].any())
    albedo, tp, resid, emittance, shape = r["backward_args"][:5]
    g = torch.Generator().manual_seed(8)
    cot = [(torch.rand((dead.shape[0], n), generator=g) + 0.5).to(cuda) * dead[:, None] for n in (3, 3)]
    d_tp, d_rad, d_atlas, d_emit = k4._backward_cuda(albedo, tp, resid, emittance, shape, *cot, None,
                                                     (True, True, True, True))
    assert torch.equal(d_tp, cot[0]) and torch.equal(d_rad, cot[1])
    assert not bool(d_atlas.any()) and not bool(d_emit.any())


@pytest.mark.gpu
@pytest.mark.parametrize("name", NEE_SCENES)
def test_nee_kernels_pass_dead_lanes_through(cuda, name):
    """The next-event kernels against their plain versions on a state with
    ~60% dead lanes, under ``check_nee``'s gate; no shadow ray is cast for a
    dead lane, its radiance leaves bit for bit as K4 wrote it, and a
    cotangent on the dead lanes alone gives nothing to the throughput, the
    albedo, the atlas or the emittance."""
    from octree_pathtracing_tpu_torch.ops import shade as k4
    from octree_pathtracing_tpu_torch.utils.timing import check_nee

    scene, st, u, _, _ = _nee_calls(name, 4072, cuda)[0]
    res = pathtracer._trace(scene, st["origin"], st["dir"])
    prim = pathtracer._prim_hit(scene, st["origin"], st["dir"]) if scene.prims is not None else None
    call = _dead((scene, st, u, res, prim, True, True), 9)
    dead = ~call[1]["active"]
    with torch.no_grad():
        out = k4.shade(*call)
    r = check_nee((scene, call[1], u, out), None, label=f"{name}, 60% dead")
    b = dead.shape[0]
    cast = r["rays"].active.view(-1, b)
    assert not bool(cast[:, dead].any())
    k_rad, _ = nee_mod._resolve_cuda(*r["args"]["resolve"])
    assert torch.equal(k_rad[dead], out.state["radiance"][dead])
    args = list(r["args"]["backward"])
    args[7] = torch.ones((b, 3), device=cuda) * dead[:, None]
    d_tp, d_rad, d_alb, d_atlas, d_emit = nee_mod._backward_cuda(*args)
    assert not bool(d_tp.any()) and not bool(d_alb.any()) and not bool(d_atlas.any()) and not bool(d_emit.any())
    assert torch.equal(d_rad, args[7])


def _resolve_cases(name, dead, dev):
    """``nee`` calls (scene, st, u, out) of ``name``: bounce 1's 65,553
    lanes and bounce 2's whole batch with its dead lanes; or (``dead``) a
    4,072-lane call with ~60% of its lanes dead."""
    from octree_pathtracing_tpu_torch.ops import shade as k4

    if not dead:
        return _forward_nee_calls(name, 65553, "shuffled", dev)
    scene, st, u, _, _ = _nee_calls(name, 4072, dev)[0]
    res = pathtracer._trace(scene, st["origin"], st["dir"])
    prim = pathtracer._prim_hit(scene, st["origin"], st["dir"]) if scene.prims is not None else None
    call = _dead((scene, st, u, res, prim, True, True), 9)
    with torch.no_grad():
        out = k4.shade(*call)
    return [(scene, call[1], u, out)]


@pytest.mark.gpu
@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("name", NEE_SCENES + ("room_k64",))
def test_nee_resolve_is_bit_equal_to_its_plain_version(cuda, name, dead):
    """``nee_resolve`` against ``nee_resolve_reference`` on the kernel's own
    rays and the same walks, bit for bit on every row: the radiance and the
    residual's ints (code, the slots' texels, the emitter's texel and
    material); without a residual, the same radiance.  Every light-line
    kind: cutout strict and lenient, terrain FAST and HIGH_QUALITY, config
    3, the room under ONE / ONE_BLOCK / ALL, analytic and plant
    HIGH_QUALITY, the world; bounce 1 and bounce 2's whole batch, and a
    state with ~60% of its lanes dead."""
    from octree_pathtracing_tpu_torch.utils.timing import _bits_differ

    for scene, st, u, out in _resolve_cases(name, dead, cuda):
        plan = nee_mod.nee_plan(scene)
        c = nee_mod._Call(scene, plan, st["cur_mat"], u, out.hitpoint, out.normal, out.mat, out.diffuse_on)
        rays = nee_mod._setup_cuda(c)
        walk, prim = nee_mod.nee_walks(scene, plan, rays)
        tp, rad, alb = st["throughput"], out.state["radiance"], out.albedo
        before = nee_mod.nee.resolve_launches
        got, got_r = nee_mod._resolve_cuda(c, rays, walk, prim, tp, rad, alb, True)
        want, want_r = nee_mod.nee_resolve_reference(scene, plan, rays, walk, prim, alb, tp, rad, st["cur_mat"])
        again, none = nee_mod._resolve_cuda(c, rays, walk, prim, tp, rad, alb, False)
        assert nee_mod.nee.resolve_launches == before + 2 and none is None
        b = tp.shape[0]
        d_rad = int(_bits_differ(got, want).sum())
        d_res = int(_bits_differ(got_r.ints.reshape(plan.faces * b, -1), want_r.ints.reshape(plan.faces * b, -1)).sum())
        print(f"nee_resolve {name}{' 60% dead' if dead else ''}: {b} lanes x {plan.faces} faces, "
              f"{int(rays.active.sum())} cast; rows not bit-equal: radiance {d_rad}, residual {d_res}")
        assert d_rad == 0 and d_res == 0
        assert torch.equal(again.view(torch.int32), got.view(torch.int32))


# ---- K5: the compaction of live lanes (csrc/compact.cu)

K5_SIZES = (1, 31, 255, 256, 257, 65536, 65553, "slots + 1", 1 << 20, 1 << 21)
K5_SHARES = ("0", "1", "0.3", "first", "last")


def _k5_slots(dev):
    """The card's resident-thread slots of ``compact_forward``'s blocks (SMs
    x resident blocks x threads): a batch one lane past them makes a block
    take a second ticket."""
    from octree_pathtracing_tpu_torch.ops import compact as k5

    c = k5.launch_config(1 << 20, dev)
    return c["sms"] * c["resident_blocks_per_sm"] * c["threads"]


def _k5_state(b, share, dev, seed=0, with_idx=True):
    g = torch.Generator().manual_seed(seed + b)
    active = {"0": torch.zeros(b, dtype=torch.bool), "1": torch.ones(b, dtype=torch.bool),
              "0.3": torch.rand(b, generator=g) < 0.3, "first": torch.arange(b) == 0,
              "last": torch.arange(b) == b - 1}[share]
    st = dict(origin=torch.randn((b, 3), generator=g), dir=torch.randn((b, 3), generator=g),
              throughput=torch.rand((b, 3), generator=g), radiance=torch.rand((b, 3), generator=g),
              active=active, specular=torch.rand(b, generator=g) < 0.5,
              cur_mat=torch.randint(0, 9, (b,), generator=g, dtype=torch.int32),
              idx=torch.randperm(b, generator=g).to(torch.int32) if with_idx else None)
    u = torch.rand((b, 5, 21), generator=g)
    return {k: None if v is None else v.to(dev) for k, v in st.items()}, u.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("share", K5_SHARES)
@pytest.mark.parametrize("b", K5_SIZES)
def test_compact_kernels_match_plain_versions_bit_for_bit(cuda, b, share):
    """``compact_forward`` against ``compact_reference`` on every output
    (state, carried index, uniforms, pos, the live count), its backward and
    the unpermute and its backward against theirs, bit for bit
    (``utils.timing.check_compact``); with and without a carried index; one
    launch a call.  Sizes around a tile (256 lanes), past the card's
    resident-thread slots, up to 2,097,152 lanes; no lane live, all, ~30%,
    a single live lane first and last."""
    from octree_pathtracing_tpu_torch.ops import compact as k5
    from octree_pathtracing_tpu_torch.utils.timing import check_compact

    if b == "slots + 1":
        b = _k5_slots(cuda) + 1
    for with_idx, bounce in ((True, 3), (False, 1)):
        st, u = _k5_state(b, share, cuda, with_idx=with_idx)
        before = k5.compact.launches
        r = check_compact(st, u, bounce, f"{b} lanes, {share} live")
        assert k5.compact.launches == before + 1
        assert r["live"] == int(st["active"].sum())


@pytest.mark.gpu
def test_compact_replays_from_a_cuda_graph_and_reuses_its_scratch(cuda):
    """Forward calls of three sizes, eager and captured in one CUDA graph
    and replayed with their outputs spoiled between replays, each equal to
    the plain version every time (the scratch's epoch carries from call to
    call, with no fill)."""
    from octree_pathtracing_tpu_torch.ops import compact as k5

    cases = [(_k5_state(b, "0.3", cuda, seed=s), s % 4 + 1) for s, b in enumerate((4097, 65536, 300))]
    want = [k5.compact_reference(st, u, bounce) for (st, u), bounce in cases]
    for _ in range(3):  # eager, many epochs
        for ((st, u), bounce), w in zip(cases, want):
            got = k5._forward_cuda(st, u, bounce, None)
            assert all(torch.equal(got[0][k], w[0][k]) for k in w[0]) and torch.equal(got[1], w[1])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [k5._forward_cuda(st, u, bounce, None) for (st, u), bounce in cases]
    for _ in range(3):
        for o in outs:
            for x in list(o[0].values()) + [o[1], o[2]]:
                x.view(torch.uint8).fill_(0xFF)
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            assert all(torch.equal(o[0][k], w[0][k]) for k in w[0]) and torch.equal(o[1], w[1])
            assert torch.equal(o[2], w[2])


@pytest.mark.gpu
@pytest.mark.parametrize("share", ["0.3", "first", "last", "1"])
def test_compact_five_calls_and_graph_replays_share_one_scratch_under_contention(cuda, share):
    """2,097,152 lanes (8,192 tiles, more than the card holds at once, so
    every block's look-back waits on others): five eager calls, then five
    calls captured in one CUDA graph and replayed three times with their
    outputs spoiled between replays, all on one scratch with no fill in
    between; every output, pos and the live count bit-equal to the plain
    version every time.  A single live lane first or last makes the
    look-back carry its count across every tile, and the dead lanes' pass
    place every other lane behind it."""
    from octree_pathtracing_tpu_torch.ops import compact as k5

    b = 1 << 21
    st, u = _k5_state(b, share, cuda, seed=7)
    counts = torch.full((5,), -1, dtype=torch.int32, device=cuda)
    want, want_u, want_pos = k5.compact_reference(st, u, 2)
    n_live = int(st["active"].sum())

    def same(out, u_b, pos, c):
        return (all(torch.equal(out[k], want[k]) for k in want) and torch.equal(u_b, want_u)
                and torch.equal(pos, want_pos) and int(c[2]) == n_live)

    scratch = k5._plan(b, 5, cuda).scratch
    for _ in range(5):
        counts.fill_(-1)
        assert same(*k5._forward_cuda(st, u, 2, counts), counts)
        assert k5._plan(b, 5, cuda).scratch is scratch
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [k5._forward_cuda(st, u, 2, counts) for _ in range(5)]
    for _ in range(3):
        counts.fill_(-1)
        for o in outs:
            for x in list(o[0].values()) + [o[1], o[2]]:
                x.view(torch.uint8).fill_(0xFF)
        graph.replay()
        torch.cuda.synchronize()
        assert all(same(*o, counts) for o in outs)


@pytest.mark.gpu
def test_compact_refuses_a_build_and_a_launch(cuda, monkeypatch):
    from octree_pathtracing_tpu_torch.ops import compact as k5
    from octree_pathtracing_tpu_torch.utils.cuda_build import load_library

    with pytest.raises(RuntimeError, match="nvcc failed"):
        load_library("compact", ("--no-such-option",))
    st, u = _k5_state(64, "0.3", cuda)
    with pytest.raises(ValueError, match="throughput"):
        k5.compact(dict(st, throughput=st["throughput"].double()), u, 1)
    with pytest.raises(ValueError, match="device"):
        k5.compact(dict(st, cur_mat=st["cur_mat"].cpu()), u, 1)
    refused = types.SimpleNamespace(compact_scratch_words=lambda n: 4, compact_forward=lambda *a: 1,
                                    compact_backward=lambda *a: 1, unpermute=lambda *a: 1,
                                    compact_error_string=lambda rc: b"invalid argument")
    monkeypatch.setattr(k5, "_library", lambda: refused)
    before = (k5.compact.launches, k5.unpermute.launches)
    with pytest.raises(RuntimeError, match="compact_forward launch failed: invalid argument"):
        k5.compact(st, u, 1)
    with pytest.raises(RuntimeError, match="unpermute launch failed: invalid argument"):
        k5.unpermute(st["radiance"], st["idx"])
    assert (k5.compact.launches, k5.unpermute.launches) == before


def _frame_case(dev, side=64):
    scene, cam = minecraft_chunk_scene(depth=5)
    scene, cam = scene.to(dev), cam.to(dev)
    o, d = pixel_grid_rays(cam, side, side)
    u = torch.from_numpy(np.random.default_rng(11).random((o.shape[0], 5, 21), dtype=np.float32)).to(dev)
    return scene, o, d, u


@pytest.mark.gpu
def test_frame_through_k5_is_one_compaction_per_bounce_and_no_index_kernel(cuda):
    """torch.profiler over one forward and one fwd+bwd frame: one
    ``compact_forward`` kernel before each bounce after the first, no
    ``compact_backward`` (its work folded into the stores of K4's backward
    and ``nee_backward``), no unpermute either way (folded into the last
    bounce's radiance stores and its backward's loads), and no ``nonzero``,
    indexing or ``index_put`` kernel and no copy from the card to the
    host.  A profiler session can drop activities, so up to
    five sessions are taken, until one records every K5 launch the
    wrappers counted."""
    from torch.profiler import ProfilerActivity, profile

    from octree_pathtracing_tpu_torch.ops import compact as k5

    scene, o, d, u = _frame_case(cuda)

    def fwd():
        pathtracer.trace_paths(scene, o, d, u)
        torch.cuda.synchronize()

    def fwd_bwd():
        p = {"atlas": scene.atlas.clone().requires_grad_(True),
             "emittance": scene.materials.emittance.clone().requires_grad_(True)}
        pathtracer.trace_paths(apply_params(scene, p), o, d, u).mean().backward()
        torch.cuda.synchronize()

    for fn, backward in ((fwd, False), (fwd_bwd, True)):
        want = [4, 0, 0]
        fn()
        for _ in range(5):
            before = (k5.compact.launches, k5.compact.backward_launches, k5.unpermute.launches,
                      k5.unpermute.backward_launches)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
            after = (k5.compact.launches, k5.compact.backward_launches, k5.unpermute.launches,
                     k5.unpermute.backward_launches)
            assert tuple(a - b for a, b in zip(after, before)) == (4, 0, 0, 0)
            names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            lowered = [x.lower() for x in names]
            bad = [x for x in lowered if "nonzero" in x or "index" in x or "scatter" in x or "dtoh" in x
                   or "device -> host" in x or "write_indices" in x or "flag_kernel" in x]
            assert not bad, bad
            counted = [sum(f"{k}_kernel" in x for x in names) for k in ("compact_forward", "compact_backward")]
            counted.append(sum("unpermute_kernel" in x for x in names))
            print(f"{'fwd+bwd' if backward else 'forward'}: {len(names)} device activities, K5 {counted}")
            if counted == want:
                break
        assert counted == want, counted


@pytest.mark.gpu
@pytest.mark.parametrize("sampling", ["importance", "high_quality"])
def test_frame_runs_without_a_sync_and_replays_from_a_cuda_graph(cuda, sampling):
    """A frame forward and fwd+bwd under ``torch.cuda.set_sync_debug_mode
    ("error")`` (any read of the card from the host raises), then the
    forward frame captured in a CUDA graph: each replay, with its output
    spoiled before it, bit-equal to the eager frame."""
    from octree_pathtracing_tpu_torch.utils.timing import capture_frame

    scene, o, d, u = _frame_case(cuda)
    if sampling == "high_quality":
        scene = dataclasses.replace(scene, sun_sampling=SunSampling.high_quality())
    eager = pathtracer.trace_paths(scene, o, d, u)
    p = {"atlas": scene.atlas.clone().requires_grad_(True),
         "emittance": scene.materials.emittance.clone().requires_grad_(True)}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = pathtracer.trace_paths(scene, o, d, u)
        pathtracer.trace_paths(apply_params(scene, p), o, d, u).mean().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(again, eager) and bool(torch.isfinite(p["atlas"].grad).all())
    graph, out = capture_frame(lambda: pathtracer.trace_paths(scene, o, d, u))
    for _ in range(3):
        out.view(torch.uint8).fill_(0xFF)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


# ---- the folds: K7's scan inside K4's forward and nee_setup, K5's backward
# inside the stores of K4's backward and nee_backward

def _analytic_call(sun, n, dev, seed):
    """The primary ``shade`` call of a frame over ``n`` lanes of the depth-5
    analytic scene under ``sun``, as a later bounce with ~60% of its lanes
    made dead (``_dead``), traversed as the bounce loop does and given no
    K7 hit (the folded forward scans the primitives itself)."""
    key = ("k4", "analytic")
    if key not in _SCENES:
        _SCENES[key] = _k4_scene("analytic")
    sc, cam = _SCENES[key]
    sc = dataclasses.replace(sc, sun_sampling=getattr(SunSampling, sun)()).to(dev)
    side = max(256, math.isqrt(n - 1) + 1)
    o, d = pixel_grid_rays(cam.to(dev), side, side)
    g = torch.Generator().manual_seed(n)
    pick = torch.randperm(o.shape[0], generator=g)[:n].to(dev)
    u = torch.from_numpy(np.random.default_rng(n).random((n, 5, 21), dtype=np.float32)).to(dev)
    calls = []
    real = pathtracer.shade

    def recording(*a):
        calls.append(a)
        return real(*a)

    pathtracer.shade = recording
    try:
        with torch.no_grad():
            pathtracer.trace_paths(sc, o[pick].contiguous(), d[pick].contiguous(), u)
    finally:
        pathtracer.shade = real
    call = _dead(calls[0], seed)
    return call[:4] + (None,) + call[5:]


def _k7_of(call):
    """K7's hit of the call's lanes (the standalone kernel), a dead lane's
    masked to a miss as the folded scan sees it."""
    scene, st = call[0], call[1]
    hit, t, mat, uv, n = pathtracer._prim_hit(scene, st["origin"], st["dir"])
    return hit & st["active"], t, mat, uv, n


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["65553", "slots + 1"])
@pytest.mark.parametrize("sun", ["importance", "high_quality"])
def test_folded_k4_is_bit_equal_to_k4_fed_by_the_standalone_k7(cuda, sun, size):
    """K4's forward with K7's scan folded in against K4's forward fed by the
    standalone K7 (its dead lanes masked to a miss): every output and the
    residual bit for bit, on the analytic scene with ~60% dead lanes; and
    against the plain version fed by K7's twin under ``check_shade``'s gate."""
    from octree_pathtracing_tpu_torch.ops import shade as k4

    if size == "slots + 1":
        key = ("k4", "analytic")
        if key not in _SCENES:
            _SCENES[key] = _k4_scene("analytic")
        n = _resident_slots(_SCENES[key][0].to(cuda)) + 1
    else:
        n = int(size)
    call = _analytic_call(sun, n, cuda, 17)
    dead = ~call[1]["active"]
    assert 0.5 < float(dead.float().mean()) < 0.7
    before = intersect_prims.launches
    folded, f_res = k4._forward_cuda(k4._Call(*call), True)
    assert intersect_prims.launches == before
    prim = _k7_of(call)
    assert bool(prim[0].any())  # the live lanes see the primitives
    fed, r_res = k4._forward_cuda(k4._Call(*call[:4], prim, *call[5:]), True)
    assert k4.launch_configs(call[0], n)["forward"]["variant"] == "scan"
    for f in k4.STATE_KEYS:
        assert torch.equal(folded.state[f].view(torch.uint8), fed.state[f].view(torch.uint8)), f
    for f in ("albedo", "hitpoint", "normal", "mat", "diffuse_on"):
        assert torch.equal(getattr(folded, f).view(torch.uint8), getattr(fed, f).view(torch.uint8)), f
    assert torch.equal(f_res.ints, r_res.ints) and torch.equal(f_res.floats.view(torch.int32),
                                                               r_res.floats.view(torch.int32))
    _assert_k4_matches_twin(call, f"analytic {sun} folded, 60% dead, {size}")  # the twin scans with K7's twin


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["1", "65536"])
@pytest.mark.parametrize("dead", [False, True])
def test_nee_setup_primitive_slots_are_bit_equal_to_k7_on_every_cast_row(cuda, size, dead):
    """``nee_setup`` on the analytic scene under HIGH_QUALITY writes, beside
    each cast shadow ray, K7's hit of that ray bit for bit (the standalone
    kernel on the rays it wrote), and a miss beside each ray not cast; the
    walks then launch no K7."""
    from octree_pathtracing_tpu_torch.ops import shade as k4

    n = int(size)
    scene, st, u, out, _ = _nee_calls("analytic_hq", n, cuda)[0]
    if dead:
        res = pathtracer._trace(scene, st["origin"], st["dir"])
        call = _dead((scene, st, u, res, None, True, True), 9)
        st = call[1]
        with torch.no_grad():
            out = k4.shade(*call)
    plan = nee_mod.nee_plan(scene)
    c = nee_mod._Call(scene, plan, st["cur_mat"], u, out.hitpoint, out.normal, out.mat, out.diffuse_on)
    rays = nee_mod._setup_cuda(c)
    assert rays.p_hit is not None
    k7 = intersect_prims(scene.prims, rays.origin, rays.dir, 1024.0)
    cast = rays.active
    for name, a, b in zip(("hit", "t", "mat", "uv"), rays.prim[:4], k7[:4]):
        assert torch.equal(a[cast].view(torch.uint8), b[cast].view(torch.uint8)), name
    assert not bool(rays.p_hit[~cast].any()) and bool(torch.isinf(rays.p_t[~cast]).all())
    if n > 1:
        assert bool(rays.p_hit.any())
    before = intersect_prims.launches
    walk, prim = nee_mod.nee_walks(scene, plan, rays)
    assert prim[0] is rays.p_hit and intersect_prims.launches == before


def _tiled(x, times):
    return x.repeat((times,) + (1,) * (x.dim() - 1))


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [65536, 2097152])
def test_backwards_through_src_are_bit_equal_to_the_unfolded_route(cuda, lanes):
    """K4's backward and ``nee_backward`` storing through ``src`` against the
    same backwards storing in place, then ``compact_backward`` through
    ``pos``: the throughput's and the radiance's gradients bit for bit, the
    atlas and emittance gradients as the kernels sum them (K4's float
    atomics within rtol 1e-5 / atol 1e-7, ``nee_backward``'s float64 sums
    bit for bit), on a config-3 bounce's lanes, repeated to ``lanes``."""
    from octree_pathtracing_tpu_torch.ops import compact as k5
    from octree_pathtracing_tpu_torch.ops import shade as k4
    from octree_pathtracing_tpu_torch.utils.timing import check_nee, check_shade

    times = lanes // 65536
    scene, st, u, out, g = _nee_calls("config3", 65536, cuda)[1]
    res = pathtracer._trace(scene, st["origin"], st["dir"], st["active"])
    call = (scene, st, u, res, None, False, True)
    gen = torch.Generator().manual_seed(lanes)
    cot = [(torch.rand((65536, k), generator=gen) + 0.5).to(cuda) for k in (3, 3, 4)]
    k4_args = list(check_shade(call, cot, label="config3 bounce 2")["backward_args"])
    nee_args = list(check_nee((scene, st, u, out), g, "config3 bounce 2")["args"]["backward"])
    for args, lane_args in ((k4_args, (0, 1, 5, 6, 7)), (nee_args, (0, 1, 7))):
        for i in lane_args:
            if args[i] is not None:
                args[i] = _tiled(args[i], times).contiguous()
    k4_args[2] = k4.ShadeResidual(*(_tiled(x, times) for x in k4_args[2]))
    nee_args[2] = nee_mod.NeeResidual(*(_tiled(x.transpose(0, 1), times).transpose(0, 1).contiguous()
                                        for x in nee_args[2]))
    src = torch.randperm(lanes, generator=gen).to(cuda, torch.int32)
    pos = torch.empty_like(src)
    pos[src.long()] = torch.arange(lanes, device=cuda, dtype=torch.int32)
    before = k5.compact.backward_launches
    d_tp, d_rad, d_atlas, d_emit = k4._backward_cuda(*k4_args, src=src)
    n_tp, n_rad, n_alb, n_atlas, n_emit = nee_mod._backward_cuda(*nee_args, src=src)
    assert k5.compact.backward_launches == before
    w_tp, w_rad, w_atlas, w_emit = k4._backward_cuda(*k4_args)
    w_tp, w_rad = k5._backward_cuda(pos, w_tp, w_rad)
    v_tp, _, v_alb, v_atlas, v_emit = nee_mod._backward_cuda(*nee_args)
    v_tp = k5._backward_cuda(pos, v_tp, None)[0]
    for a, b in ((d_tp, w_tp), (d_rad, w_rad), (n_tp, v_tp), (n_alb, v_alb), (n_atlas, v_atlas), (n_emit, v_emit)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    torch.testing.assert_close(d_atlas, w_atlas, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(d_emit, w_emit, rtol=1e-5, atol=1e-7)


def _frame_kernels(fn):
    """The kernels torch.profiler records over ``fn()`` by name (the
    fullest of five sessions, each counting the second of two calls:
    ``utils/timing.profiled_names``, since a session can drop the first
    activities of the first)."""
    from octree_pathtracing_tpu_torch.utils.timing import profiled_names

    best = []
    fn()
    for _ in range(5):
        names = profiled_names(fn)
        if len(names) > len(best):
            best = names
    return best


@pytest.mark.gpu
@pytest.mark.parametrize("line", ["analytic", "analytic_hq", "terrain_fwd_bwd", "config3_fwd_bwd"])
def test_frames_launch_no_k7_and_no_compact_backward(cuda, line):
    """A frame through the folds against the same frame through the route
    before them (``utils/timing.unfolded``): the same radiance bit for bit
    and (with a gradient) the same atlas and emittance gradients within
    rtol 1e-5 / atol 1e-7 (K4's backward adds them with float atomics in
    the schedule's order; the elements not bit-equal are printed); no K7
    kernel, no ``compact_backward`` and no unpermute among its kernels; and
    the kernels the route before it launched and the folds do not are those
    three (the unpermute once forward, once more with a gradient) and the
    copy that made the primaries dense for K7 (its first bounce's rays),
    nothing else, with no kernel of its own."""
    from octree_pathtracing_tpu_torch.utils.timing import unfolded

    if line.startswith("analytic"):
        sc, cam = analytic_sphere_scene(depth=5)
        sc = dataclasses.replace(sc, sun_sampling=SunSampling.high_quality() if line == "analytic_hq"
                                 else SunSampling.importance())
    else:
        sc, cam = minecraft_chunk_scene(depth=5)
        if line.startswith("config3"):
            sc = emitters.with_emitter_sampling(dataclasses.replace(sc, sun_sampling=SunSampling.high_quality()),
                                                "one")
    sc, cam = sc.to(cuda), cam.to(cuda)
    o, d = pixel_grid_rays(cam, 64, 64)
    u = torch.from_numpy(np.random.default_rng(21).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)
    grad = line.endswith("fwd_bwd")

    def frame():
        if not grad:
            return pathtracer.trace_paths(sc, o, d, u), None
        p = {"atlas": sc.atlas.clone().requires_grad_(True),
             "emittance": sc.materials.emittance.clone().requires_grad_(True)}
        rad = pathtracer.trace_paths(apply_params(sc, p), o, d, u)
        rad.mean().backward()
        return rad.detach(), {k: v.grad for k, v in p.items()}

    def synced():
        frame()
        torch.cuda.synchronize()

    got, got_g = frame()
    folded = _frame_kernels(synced)
    with unfolded(pathtracer):
        want, want_g = frame()
        before = _frame_kernels(synced)
    from collections import Counter

    def kinds(names):  # K4's forward and nee_setup by kernel, whichever variant (K7's scan folded in or not)
        return Counter(x.replace("<true>", "").replace("<false>", "") if "shade_forward_kernel" in x
                       or "nee_setup_kernel" in x else x for x in names)

    gone, new = kinds(before) - kinds(folded), kinds(folded) - kinds(before)
    print(f"{line}: kernels only before the folds {dict(gone)}; only through them {dict(new)}")
    assert torch.equal(got, want)
    if grad:
        for k in got_g:
            print(f"{line} {k} gradient: {int((got_g[k] != want_g[k]).sum())} elements not bit-equal")
            torch.testing.assert_close(got_g[k], want_g[k], rtol=1e-5, atol=1e-7)
    k7 = sum("prims_intersect_kernel" in x for x in before)
    k5b = sum("compact_backward_kernel" in x for x in before)
    k5u = sum("unpermute_kernel" in x for x in before)
    print(f"{line}: {len(folded)} device activities through the folds, {len(before)} before them "
          f"({k7} K7, {k5b} compact_backward, {k5u} unpermute)")
    assert not any("prims_intersect_kernel" in x or "compact_backward_kernel" in x or "unpermute_kernel" in x
                   for x in folded)
    assert (k7 > 0) == line.startswith("analytic") and (k5b == 4) == grad and k5u == (2 if grad else 1)
    copies = sum(n for x, n in gone.items() if "direct_copy_kernel" in x)
    assert not new and copies <= 1 and sum(gone.values()) == k7 + k5b + k5u + copies


@pytest.mark.gpu
@pytest.mark.parametrize("sun", ["importance", "high_quality"])
def test_analytic_frames_replay_from_a_cuda_graph(cuda, sun):
    """The analytic scene's forward frame (K4's scanning variant, and under
    HIGH_QUALITY ``nee_setup``'s) and its fwd+bwd frame (the backwards
    storing through ``src``) captured in CUDA graphs: each replay, its
    outputs spoiled before it, bit-equal to the eager frame (the gradients
    within rtol 1e-5 / atol 1e-7: float atomics add in the schedule's
    order)."""
    from octree_pathtracing_tpu_torch.utils.timing import capture_frame

    sc, cam = analytic_sphere_scene(depth=5)
    sc = dataclasses.replace(sc, sun_sampling=getattr(SunSampling, sun)()).to(cuda)
    o, d = pixel_grid_rays(cam.to(cuda), 64, 64)
    u = torch.from_numpy(np.random.default_rng(22).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)
    eager = pathtracer.trace_paths(sc, o, d, u)
    graph, out = capture_frame(lambda: pathtracer.trace_paths(sc, o, d, u))
    for _ in range(2):
        out.view(torch.uint8).fill_(0xFF)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    p = {"atlas": sc.atlas.clone().requires_grad_(True),
         "emittance": sc.materials.emittance.clone().requires_grad_(True)}

    def step():
        for v in p.values():
            v.grad = None
        rad = pathtracer.trace_paths(apply_params(sc, p), o, d, u)
        rad.mean().backward()
        return rad

    rad_eager = step().detach().clone()
    grads = {k: v.grad.clone() for k, v in p.items()}
    graph, rad = capture_frame(step)
    for _ in range(2):
        rad.detach().view(torch.uint8).fill_(0xFF)
        for v in p.values():
            v.grad.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(rad.detach(), rad_eager)
        for k, v in p.items():
            torch.testing.assert_close(v.grad, grads[k], rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["terrain_d9", "nee", "analytic"])
def test_last_bounce_stores_are_bit_equal_to_the_writer_then_the_unpermute(cuda, name):
    """The last bounce of a 65,536-lane frame (the headline's depth-9
    terrain under IMPORTANCE: K4 writes the radiance; the NEE line: the
    terrain under HIGH_QUALITY, ``nee_resolve`` writes it; the analytic
    scene: K4 with K7's scan) shaded with the compaction's ``idx`` against
    the same bounce storing in row order, then the standalone
    ``unpermute_kernel``: every output bit for bit; and backward, with a
    cotangent that differs lane by lane, against the unpermute's gather
    then the bounce's backwards: the incoming throughput's and radiance's
    gradients bit for bit, the atlas's and emittance's within rtol 1e-5 /
    atol 1e-7 (K4's float atomics add in the schedule's order)."""
    from octree_pathtracing_tpu_torch.ops import compact as k5
    from octree_pathtracing_tpu_torch.ops import shade as k4
    from octree_pathtracing_tpu_torch.utils.timing import shade_calls

    key = ("fold", name)
    if key not in _SCENES:
        _SCENES[key] = _nee_scene(name) if name == "nee" else _k4_scene(name)
    sc, cam = (x.to(cuda) for x in _SCENES[key])
    o, d = pixel_grid_rays(cam, 256, 256)
    u = torch.from_numpy(np.random.default_rng(31).random((o.shape[0], 5, 21), dtype=np.float32)).to(cuda)
    *_, (scene, st, uu, res, is_first, may_scatter, idx) = shade_calls(pathtracer, sc, o, d, u)
    assert idx is not None and not may_scatter and idx.shape == (65536,)
    light = nee_mod.samples_light(scene)
    assert light == (name == "nee")
    counts = (k4.shade.idx_launches, nee_mod.nee.idx_resolve_launches, k5.unpermute.launches)
    folded = pathtracer._shade(scene, st, uu, res, is_first, may_scatter, idx)
    assert (k4.shade.idx_launches - counts[0], nee_mod.nee.idx_resolve_launches - counts[1],
            k5.unpermute.launches - counts[2]) == ((0, 1, 0) if light else (1, 0, 0))
    rows = pathtracer._shade(scene, st, uu, res, is_first, may_scatter)
    assert k5.unpermute.launches == counts[2]
    want = k5.unpermute(rows["radiance"], idx)
    assert torch.equal(folded["radiance"].view(torch.int32), want.view(torch.int32))
    assert not torch.equal(rows["radiance"], want)  # the lanes' order is not the rows'
    for f in k4.STATE_KEYS[:3] + k4.STATE_KEYS[4:]:
        assert torch.equal(folded[f], rows[f]), f

    g = (torch.rand((65536, 3), generator=torch.Generator().manual_seed(32)) + 0.5).to(cuda)

    def backward(fold):
        p = {"atlas": scene.atlas.clone().requires_grad_(True),
             "emittance": scene.materials.emittance.clone().requires_grad_(True)}
        s = dict(st, throughput=st["throughput"].clone().requires_grad_(True),
                 radiance=st["radiance"].clone().requires_grad_(True))
        if fold:
            rad = pathtracer._shade(apply_params(scene, p), s, uu, res, is_first, may_scatter, idx)["radiance"]
        else:
            rad = k5.unpermute(pathtracer._shade(apply_params(scene, p), s, uu, res, is_first, may_scatter)["radiance"],
                               idx)
        rad.backward(g)
        return {"throughput": s["throughput"].grad, "radiance": s["radiance"].grad, **{k: v.grad for k, v in p.items()}}

    before = (k4.shade.idx_backward_launches, nee_mod.nee.idx_backward_launches, k5.unpermute.backward_launches)
    got = backward(True)
    assert (k4.shade.idx_backward_launches - before[0], nee_mod.nee.idx_backward_launches - before[1],
            k5.unpermute.backward_launches - before[2]) == ((0, 1, 0) if light else (1, 0, 0))
    ref = backward(False)
    assert k5.unpermute.backward_launches == before[2] + 1
    for k in ("throughput", "radiance"):
        assert torch.equal(got[k].view(torch.int32), ref[k].view(torch.int32)), k
    for k in ("atlas", "emittance"):
        print(f"{name} {k} gradient: {int((got[k] != ref[k]).sum())} elements not bit-equal")
        torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-7)
    assert float(got["throughput"].abs().max()) > 0


def _plant_soup_quads(depth: int):
    """The plants of ``plant_scene(depth)`` as a world-space quad soup
    (``utils/timing.plant_soup``), with a BVH built over their boxes (leaves
    of 2)."""
    from octree_pathtracing_tpu_torch.utils.timing import plant_soup

    scene, cam = plant_scene(depth=depth)
    o, u, v, mat = plant_soup(scene)
    corners = np.stack([o, o + u, o + v, o + u + v])
    bvh = build_bvh(corners.min(0) - 1e-4, corners.max(0) + 1e-4)
    return scene, cam, bvh, make_quads(o, u, v, mat)


@pytest.mark.gpu
def test_bvh_kernel_matches_twin_on_the_plant_soup(cuda):
    """K8 on a BVH built over a plant field's quads, against the plant
    primaries (65,536 rays), without and with the octree's hit t as
    ``t_init``: hit, t and payload bit for bit; its stack in shared memory
    (no local-memory stack frame), the tree's depth + 1 entries a ray."""
    from octree_pathtracing_tpu_torch.ops import bvh as k8

    scene, cam, bvh, quads = _plant_soup_quads(6)
    bvh, quads, scene, cam = bvh.to(cuda), quads.to(cuda), scene.to(cuda), cam.to(cuda)
    o, d = (x.contiguous() for x in pixel_grid_rays(cam, 256, 256))
    res = pathtracer._trace(scene, o, d)
    attrs = k8.launch_attributes(bvh)
    print(f"K8 on {bvh.prim_order.shape[0]} quads, depth {bvh.depth}: {attrs}")
    assert attrs["stack_frame_bytes"] == 0 and attrs["stack_entries"] == bvh.depth + 1
    for t_init in (None, torch.where(res.hit, res.t, float("inf")).contiguous()):
        stats = {}
        k = bvh_intersect_quads(bvh, quads, o, d, t_init)
        r = bvh_intersect_reference(bvh, o, d, quad_prim_fn(quads), t_init, stats=stats)
        torch.cuda.synchronize()
        for f, a, b in zip(("hit", "t", "payload"), k, r):
            assert torch.equal(a, b), f
        print(f"t_init {t_init is not None}: hits {int(k[0].sum())}; the twin's walk {stats}; rows the kernel "
              f"reads {o.shape[0] + 2 * stats['interior']} (the twin's {stats['nodes'] + 2 * stats['interior']})")
        if t_init is None:  # the octree's own hit is the plant's, so few quads lie nearer than it
            assert int(k[0].sum()) > 100


@pytest.mark.gpu
def test_bvh_kernel_refuses_a_tree_deeper_than_its_stack_and_fills_it_whole(cuda, monkeypatch):
    """A chain of depth 63 (64 entries, the whole 48 KB of a block's stack)
    walks bit-equal to the twin; depth 64 is refused before any launch, and
    so is a tree deeper than a smaller capacity."""
    from octree_pathtracing_tpu_torch.ops import bvh as k8

    def chain(depth):  # each interior node: a leaf on the left, the rest of the chain on the right
        left, right = [], []
        for k in range(depth - 1):
            left += [2 * k + 1, k8.LEAF_FLAG | k]
            right += [2 * k + 2, 1]
        left.append(k8.LEAF_FLAG | (depth - 1))
        right.append(1)
        lo = np.tile(np.float32([[-1.0, -1.0, -1.0]]), (len(left), 1))
        return k8.BVH.from_arrays(lo, -lo, left, right, np.arange(depth) % 64).to(cuda)

    rng = np.random.default_rng(41)
    quads = make_quads(*(rng.uniform(-1, 1, (64, 3)).astype(np.float32) for _ in range(3)),
                       np.zeros(64, np.int32)).to(cuda)
    o = torch.from_numpy(rng.uniform(-3, 3, (4096, 3)).astype(np.float32)).to(cuda)
    d = torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32)).to(cuda)
    deep = chain(63)
    assert k8.launch_attributes(deep)["stack_entries"] == k8.STACK_CAPACITY
    k = bvh_intersect_quads(deep, quads, o, d)
    r = bvh_intersect_reference(deep, o, d, quad_prim_fn(quads))
    for f, a, b in zip(("hit", "t", "payload"), k, r):
        assert torch.equal(a, b), f
    assert int(k[0].sum()) > 0
    before = bvh_intersect_quads.launches
    with pytest.raises(ValueError, match="64 levels deep"):
        bvh_intersect_quads(chain(64), quads, o, d)
    monkeypatch.setattr(k8, "STACK_CAPACITY", 8)
    with pytest.raises(ValueError, match="8 levels deep.*holds 8 entries"):
        bvh_intersect_quads(chain(8), quads, o, d)
    assert bvh_intersect_quads.launches == before


# ---- K10, the preview's shading kernel, and the sharded steps on the card


def _preview_case(name, dev):
    """(scene, dirs, walk) of 65,536 lanes: the 256x256 primaries of a
    preview scene, the first 4,096 of them moved above the scene and aimed
    around the sun so that the sun's window is in the batch."""
    from octree_pathtracing_tpu_torch.render.pathtracer import _trace

    build = {"chunk": minecraft_chunk_scene, "cutout": cutout_chunk_scene, "plant": plant_scene}[name]
    scene, cam = build(depth=6)
    scene, cam = scene.to(dev), cam.to(dev)
    o, d = pixel_grid_rays(cam, 256, 256)
    o, d = o.clone(), d.clone()
    rng = np.random.default_rng(17)
    jit = torch.from_numpy(rng.normal(0.0, 0.08, (4096, 3)).astype(np.float32)).to(dev)
    sun = scene.sun.sw[None, :] + jit
    d[:4096] = sun / torch.linalg.norm(sun, dim=1, keepdim=True)
    o[:4096] = torch.tensor([32.0, 256.0, 32.0], device=dev)
    return scene, d, _trace(scene, o, d)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["chunk", "cutout", "plant"])
def test_preview_kernel_matches_twin(cuda, name):
    """K10 equals its twin bit for bit on every pixel, one launch a call;
    the plant field's walk hands it K2q's quad surfaces."""
    from octree_pathtracing_tpu_torch.ops.preview import preview_shade, preview_shade_reference

    scene, d, res = _preview_case(name, cuda)
    assert (res.quad is not None) == (name == "plant")
    before = preview_shade.launches
    got = preview_shade(scene, d, res)
    torch.cuda.synchronize()
    assert preview_shade.launches == before + 1
    want = preview_shade_reference(scene, d, res)
    assert got.shape == (65536, 3) and torch.equal(got, want), float((got - want).abs().max())
    hit = res.hit
    assert bool(hit.any()) and bool((~hit).any())
    sky = torch.tensor([0.5, 0.7, 1.0], device=cuda)
    assert bool((got[~hit] != sky).any(dim=1).any())  # the sun's window was drawn
    quad = None if res.quad is None else type(res.quad)(*(x[:0] for x in res.quad))
    empty = preview_shade(scene, d[:0], res._replace(quad=quad, **{f: getattr(res, f)[:0] for f in
                                                                   ("hit", "face_id", "uv", "leaf_value")}))
    assert empty.shape == (0, 3) and preview_shade.launches == before + 1


@pytest.mark.gpu
def test_preview_kernel_refuses_what_it_does_not_take(cuda):
    from octree_pathtracing_tpu_torch.ops.preview import preview_shade

    scene, d, res = _preview_case("plant", cuda)
    with pytest.raises(ValueError, match="quad"):
        preview_shade(scene, d, res._replace(quad=None))
    with pytest.raises(ValueError, match="face_id"):
        preview_shade(scene, d, res._replace(face_id=res.face_id.long()))


@pytest.mark.gpu
def test_preview_image_on_the_card_launches_k10(cuda):
    from octree_pathtracing_tpu_torch.ops.preview import preview_shade
    from octree_pathtracing_tpu_torch.render.preview import preview_image

    scene, cam = cutout_chunk_scene(depth=5)
    k2, k10 = traverse_alpha.launches, preview_shade.launches
    img = preview_image(scene.to(cuda), cam.to(cuda), 64, 48)
    torch.cuda.synchronize()
    assert img.shape == (48, 64, 3) and img.is_cuda and bool(torch.isfinite(img).all())
    assert traverse_alpha.launches == k2 + 1 and preview_shade.launches == k10 + 1


@pytest.mark.gpu
def test_two_ranks_share_the_card_through_gloo(cuda):
    """Two spawned ranks (gloo) run the sharded render in both layouts and
    the train step on the card, after this process built every library:
    the image equals the unsharded average within rtol and atol 1e-6, the
    loss and gradients the unsharded step's within rtol 1e-5 / atol 1e-7."""
    from octree_pathtracing_tpu_torch.ops import compact, preview, shade
    from octree_pathtracing_tpu_torch.ops import traversal as traversal_mod
    from octree_pathtracing_tpu_torch.parallel import render_loss, spawn_ranks
    from torch_sharded_rank import rank_steps
    from octree_pathtracing_tpu_torch.render import trace_paths

    for lib in (traversal_mod._library, prandom._library, shade._library, nee_mod._library, compact._library,
                preview._library):
        lib()
    scene, cam = minecraft_chunk_scene(depth=5)
    o, d = pixel_grid_rays(cam, 32, 32)
    s, b, nb = 2, o.shape[0], 2
    u = torch.from_numpy(np.random.default_rng(9).random((s, b, nb, 21), dtype=np.float32))
    O, D = o[None].expand(s, b, 3).contiguous(), d[None].expand(s, b, 3).contiguous()
    tgt = torch.full((s, b, 3), 0.25)
    ranks = spawn_ranks(rank_steps, 2, "gloo", (scene, O, D, u, tgt, (1, 2), (1, 2), "cuda"), timeout=300)
    sc = scene.to(cuda)
    want = sum(trace_paths(sc, o.to(cuda), d.to(cuda), u[k].to(cuda)) for k in range(s)).cpu().numpy() / s
    p = {"atlas": sc.atlas.detach().requires_grad_(True), "emittance": sc.materials.emittance.detach().requires_grad_(True)}
    flat = lambda x: x.reshape((s * b,) + tuple(x.shape[2:])).to(cuda)  # noqa: E731
    loss = render_loss(sc, p, flat(O), flat(D), flat(u), flat(tgt))
    grads = torch.autograd.grad(loss, [p["atlas"], p["emittance"]])
    for r in ranks:
        for sp in (1, 2):
            np.testing.assert_allclose(r["render"][sp], want, rtol=1e-6, atol=1e-6)
            got_loss, g = r["train"][sp]
            assert got_loss == pytest.approx(float(loss), rel=1e-5, abs=1e-7)
            np.testing.assert_allclose(g["atlas"], grads[0].cpu().numpy(), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(g["emittance"], grads[1].cpu().numpy(), rtol=1e-5, atol=1e-7)
