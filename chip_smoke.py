#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``octree_pathtracing_tpu_torch``) on
one NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. the card's name and power limit; build the kernels from the sources in
   this checkout, one nvcc per source, started together: the traversal
   (``csrc/traversal.cu``: K1, K2 alpha accept, K3r recording walk, K3s
   shadow walk), P2 (``csrc/uniforms.cu``, Philox uniforms) and P1
   (``csrc/gather.cu``, row gather);
2. every kernel against its plain-torch twin on the card, timed beside its
   bound (and, for P2, beside ``torch.rand``):
   - K1 on a random depth-4 octree (4096 rays with an active mask) and on
     the 256x256 primaries of the depth-9 terrain;
   - P2 on the (65536, 5, 21) uniform block and on a ragged size, bit for
     bit;
   - K2 on the 256x256 primaries of the depth-9 cutout scene and on its
     8 training views at 512x512; K3r on the 256x256 primaries of both
     depth-9 scenes and on the 8 training views of both;
   - K3s on shadow rays from the hit points of the depth-9 cutout's 256x256
     primaries: toward sun directions drawn by ``random_sun_direction``
     (strict, no t), and toward ``sample_emitter_point`` points (t
     recorded, the attenuation truncated at ``max_t``); beside K1 on the
     same rays;
   - P1 at the probe's shape (a (131072, 8) int32 table, 4096 indices) and
     at the emitter grid's ((4096, 8) float32 ``grid_w`` of the cutout, the
     65536 supercells of its primaries' hit points), bit for bit, beside
     ``torch.index_select``.
   Hit, leaf value, face id, fetch counts and record count / mats / face
   must agree on every lane; t, uv and the record's uu / vv within 1e-4 (all
   of them round every operation once, so they should agree exactly); K3s's
   record (count, w, medium, mats, uu, vv, ts) must be equal bit for bit;
3. the forward main path: ``Renderer(256x256, 5 bounces, branch_count=10,
   target_spp=20)`` on ``minecraft_chunk_scene(depth=9)`` to the end —
   passes of 1, 1, 1, 1, 6 and 10 samples; the frame must be finite with a
   positive mean, and K1 and P2 must have been launched;
3b. the light-sampling entry point: ``cli render --scene cutout --depth 9
   --width 256 --height 256 --spp 20 --sun high_quality --emitter-sampling
   one --device cuda``; the frame must be finite with a positive mean, and
   K2, K3s, P1 and P2 must have been launched;
4. frame parity: one 64x64, 5-bounce frame of each depth-9 scene from a
   fixed uniform block, through the kernels and through the twins, with the
   IMPORTANCE sun and with HIGH_QUALITY + ``EmitterSampling.ONE``; per-lane
   rtol and atol 2e-3, at most 0.1% of the lanes outside;
5. timing of the forward frame (256x256, 5 bounces, median of 5 after a
   warm-up), with nominal and live rays per second;
6. bench.py's fwd+bwd step (``jax.grad`` of the mean radiance into atlas and
   emittance, bench.py:61-71) on the depth-9 terrain at 256x256 and
   5 bounces: median of 5 after a warm-up, rays/s, peak memory; and the
   gradient through the kernels against the gradient through the twins at
   64x64, per element within rtol 1e-5 / atol 1e-7 (the backward of the
   atlas gather accumulates in an order the card does not fix);
6b. bench.py's NEE line (terrain, HIGH_QUALITY: the binary shadow walk), its
   cutout line (cutout, HIGH_QUALITY: K3s) and BASELINE's config 3 (terrain
   with its glowstone emitters, HIGH_QUALITY + ``EmitterSampling.ONE``),
   each forward and fwd+bwd at phase 5's shape, with rays/s and peak
   memory; the gradients must be finite; the emitter count of each scene;
7. the training entry point: ``cli train`` (``inverse_render``, soft weight
   0.25) with the JAX CLI's defaults of 8 views at 512x512 for 3 steps, on
   ``--scene chunk --depth 9`` (K1, K3r, P2) and on ``--scene cutout
   --depth 9`` (K2, K3r, P2): finite losses, the parameters written, wall
   seconds per step.

The launch counts of the main paths (phases 3, 3b, 6, 6b and 7) are set
to 0 just before each path and read just after; the kernels' comparisons
with their twins do not count.  The script names only the port; jax and the JAX
package are blocked before anything is imported.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it the card's name and power limit, and the one before
that the kernels' JSON line.  It exits non-zero without a CUDA card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np

WIDTH = HEIGHT = 256
N_BOUNCES = 5
DEPTH = 9
TRAIN_VIEWS, TRAIN_RES, TRAIN_STEPS = 8, 512, 3
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# arithmetic per fetched node row: up to two examinations of ~30 float
# operations each, plus the slot select
OPS_PER_FETCH = 64
# bytes per ray the traversal reads (origin, dir) and writes (hit, t, face,
# uv, leaf, voxel corner and size, fetch count); K3r adds its record
RAY_BYTES = 24 + 41
RECORD_BYTES = 4 + 4 * 16
# K3s: the lane's medium in; count, w, medium and 4 (mat, uu, vv) rows out;
# 4 ts more when t is recorded
SHADOW_BYTES = 4 + 12 + 4 * 12
SHADOW_T_BYTES = 16
PHILOX_OPS_PER_BLOCK = 112  # 10 rounds of 2 mul-hi/lo pairs, 4 xor, 2 key adds; 4 float maps

KERNELS = {
    "esvo_traverse": ("octree_pathtracing_tpu_torch/csrc/traversal.cu",
                      "octree_pathtracing_tpu/ops/traversal.py:459"),
    "esvo_traverse_alpha": ("octree_pathtracing_tpu_torch/csrc/traversal.cu",
                            "octree_pathtracing_tpu/render/hit.py:104"),
    "esvo_traverse_record": ("octree_pathtracing_tpu_torch/csrc/traversal.cu",
                             "octree_pathtracing_tpu/diff/soft.py:96"),
    "esvo_traverse_shadow": ("octree_pathtracing_tpu_torch/csrc/traversal.cu",
                             "octree_pathtracing_tpu/render/hit.py:223"),
    "philox_uniforms": ("octree_pathtracing_tpu_torch/csrc/uniforms.cu",
                        "tools/profile_pallas.py:114"),
    "row_gather": ("octree_pathtracing_tpu_torch/csrc/gather.cu",
                   "tools/profile_pallas.py:67"),
}
# bench.py's lines and BASELINE's config 3 at bench.py's shapes:
# (name, scene, emitter sampling); every one runs the HIGH_QUALITY sun
LIGHT_CELLS = (("nee", "terrain", "none"), ("cutout", "cutout", "none"), ("config3", "terrain", "one"))


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the card in use, as nvidia-smi prints them."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    idx = int(first) if first.isdigit() else 0
    return lines[idx] if idx < len(lines) else lines[0]


def cuda_ms(fn, repeats: int) -> float:
    """Mean device ms per call over ``repeats`` calls, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / MEM_BYTES_PER_S, n_ops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def traversal_bound(res, record_bytes: int = 0):
    """The traversal's bound on one call's result: the node rows its lanes
    fetched (32 B each) plus the rays' inputs and outputs (and
    ``record_bytes`` per lane of a record), against OPS_PER_FETCH operations
    per row."""
    fetches = int(res.fetches.sum())
    lanes = int(res.hit.shape[0])
    n_bytes = fetches * 32 + lanes * (RAY_BYTES + record_bytes)
    return bound(n_bytes, fetches * OPS_PER_FETCH) + (fetches,)


def gather_bound(table, n_out: int):
    """P1's bound: the indices and the output rows, and the table's rows read
    once (the rows gathered, or the whole table when that is smaller)."""
    row = table.shape[1] * 4
    return bound(n_out * (4 + row) + min(table.shape[0], n_out) * row, 0)


def compare_hits(k, r, label: str, k_rec=None, r_rec=None) -> float:
    """Fail unless a kernel's result ``k`` (and record) matches the twin's
    ``r`` on every lane; returns the largest absolute difference of t, uv,
    the voxel corner and the record's uu / vv."""
    mismatch = {f: int((getattr(k, f) != getattr(r, f)).sum()) for f in ("hit", "leaf_value", "face_id", "fetches")}
    h = r.hit
    t_err = (k.t[h] - r.t[h]).abs()
    t_bad = int((t_err > 1e-4 * r.t[h].abs().clamp(min=1.0)).sum())
    uv_err = (k.uv[h] - r.uv[h]).abs()
    uv_bad = int((uv_err > 1e-4).any(dim=-1).sum())
    vpos_err = (k.voxel_pos[h] - r.voxel_pos[h]).abs()
    errs = [t_err, uv_err, vpos_err]
    if k_rec is not None:
        for f in ("count", "mats", "face"):
            mismatch[f"record_{f}"] = int((getattr(k_rec, f) != getattr(r_rec, f)).sum())
        rec_err = [(getattr(k_rec, f) - getattr(r_rec, f)).abs() for f in ("uu", "vv")]
        uv_bad += int(sum(int((e > 1e-4).sum()) for e in rec_err))
        errs += rec_err
    err = max(float(x.max()) if x.numel() else 0.0 for x in errs)
    log(f"  {label}: lanes={r.hit.numel()} hits={int(h.sum())} mismatches={mismatch} "
        f"t_out_of_tol={t_bad} uv_out_of_tol={uv_bad} max_abs_err={err!r} "
        f"steps kernel={int(k.steps)} twin={int(r.steps)}")
    if any(mismatch.values()) or t_bad or uv_bad:
        raise AssertionError(f"kernel disagrees with its twin on {label}")
    return err


def reset_counts(mods):
    for fn in mods:
        fn.launches = 0


def main() -> int:
    # The port never needs jax or the JAX package; block both so that no
    # module reached from here loads them.
    sys.modules["jax"] = None
    sys.modules["octree_pathtracing_tpu"] = None
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 1

    from octree_pathtracing_tpu_torch import BUILD_DIR, cli
    from octree_pathtracing_tpu_torch.io.checkpoint import load_arrays
    from octree_pathtracing_tpu_torch.io.image import save_image
    from octree_pathtracing_tpu_torch.models import (
        cutout_chunk_scene,
        emitters,
        face_normals,
        minecraft_chunk_scene,
        octree_from_grid,
        pixel_grid_rays,
    )
    from octree_pathtracing_tpu_torch.models.emitters import sample_emitter_point, with_emitter_sampling
    from octree_pathtracing_tpu_torch.models.sun import SunSampling, random_sun_direction
    from octree_pathtracing_tpu_torch.ops import gather
    from octree_pathtracing_tpu_torch.ops import random as prandom
    from octree_pathtracing_tpu_torch.ops import traversal
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
    from octree_pathtracing_tpu_torch.render import Renderer, pathtracer, renderer, trace_paths, trace_paths_census
    from octree_pathtracing_tpu_torch.render.hit import accept_tables

    wrappers = {"esvo_traverse": traverse, "esvo_traverse_alpha": traverse_alpha,
                "esvo_traverse_record": traverse_record, "esvo_traverse_shadow": traverse_shadow,
                "philox_uniforms": philox_uniforms, "row_gather": row_gather}

    @contextlib.contextmanager
    def twins():
        """Every kernel's wrapper replaced by its twin where the paths call it."""
        with mock.patch.object(pathtracer, "traverse", traverse_reference), \
                mock.patch.object(pathtracer, "traverse_alpha", traverse_alpha_reference), \
                mock.patch.object(pathtracer, "traverse_shadow", traverse_shadow_reference), \
                mock.patch.object(emitters, "row_gather", row_gather_reference):
            yield

    def high_quality(sc, emitter_sampling="none"):
        """``sc`` under the HIGH_QUALITY sun and ``--emitter-sampling``."""
        return with_emitter_sampling(dataclasses.replace(sc, sun_sampling=SunSampling.high_quality()),
                                     emitter_sampling)
    main_path_launches = dict.fromkeys(wrappers, 0)

    def read_counts(path: str, required):
        counts = {name: fn.launches for name, fn in wrappers.items()}
        for name, n in counts.items():
            main_path_launches[name] += n
        log(f"  launches on {path}: {counts}")
        missing = [name for name in required if counts[name] <= 0]
        if missing:
            raise AssertionError(f"{path} never launched {missing}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} count {torch.cuda.device_count()}")
    out_dir = os.path.join(BUILD_DIR, "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)

    # ---- 1. build the kernels from the checkout's sources, in parallel
    t0 = time.perf_counter()
    builds, errors = {}, []

    def build(name, loader):
        try:
            builds[name] = loader()
        except Exception as e:  # re-raised below, after both builds end
            errors.append(e)

    threads = [threading.Thread(target=build, args=a)
               for a in (("traversal", traversal._library), ("uniforms", prandom._library),
                         ("gather", gather._library))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    log(f"phase 1 build: the three libraries loaded in {time.perf_counter() - t0:.2f} s")
    for name, lib in builds.items():
        info = lib.build_info
        log(f"  {name}: nvcc {info['seconds']:.2f} s -> {os.path.relpath(info['path'])}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line or "Compiling" in line:
                log(f"    ptxas: {line.strip()}")

    results = {name: {} for name in wrappers}

    # ---- 2. every kernel against its twin on the card
    log("phase 2 kernels vs twins:")
    rng = np.random.default_rng(2024)
    s = 16
    grid = (rng.random((s, s, s)) < 0.12).astype(np.uint32) * rng.integers(1, 10, (s, s, s)).astype(np.uint32)
    tree = octree_from_grid(grid)
    nodes = pack_nodes(torch.from_numpy(tree.child_mask.astype(np.int64)),
                       torch.from_numpy(tree.child_data.astype(np.int64))).to(dev)
    o = rng.uniform(-s, 2 * s, (4096, 3))
    d = rng.uniform(0, s, (4096, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.from_numpy(o.astype(np.float32)).to(dev)
    d = torch.from_numpy(d.astype(np.float32)).to(dev)
    active = torch.from_numpy(rng.random(4096) < 0.8).to(dev)
    args = (nodes, tree.root, tree.depth, tree.scale(), o, d, 1024.0, active)
    err_k1 = compare_hits(traverse(*args), traverse_reference(*args), "K1, random depth-4 octree, 4096 rays")

    t0 = time.perf_counter()
    scene_cpu, cam_cpu = minecraft_chunk_scene(depth=DEPTH)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cut_cpu, cut_cam_cpu = cutout_chunk_scene(depth=DEPTH)
    cut_build_s = time.perf_counter() - t0
    scene, cam = scene_cpu.to(dev), cam_cpu.to(dev)
    cut, cut_cam = cut_cpu.to(dev), cut_cam_cpu.to(dev)
    torch.cuda.synchronize()
    log(f"  depth-{DEPTH} terrain built in {build_s:.2f} s on the host: {scene.n_nodes} nodes, "
        f"{scene.nodes.numel() * 4 / 1e6:.1f} MB node table; cutout scene {cut_build_s:.2f} s, "
        f"{cut.n_nodes} nodes")

    def primaries(sc, camera, w, h):
        po, pd = pixel_grid_rays(camera, w, h)
        return (sc.nodes, sc.root, sc.depth, sc.octree_scale, po.contiguous(), pd.contiguous())

    def training_rays(sc):
        rays = [pixel_grid_rays(c.to(dev), TRAIN_RES, TRAIN_RES) for c in cli.orbit_cameras(sc.depth, TRAIN_VIEWS)]
        return (sc.nodes, sc.root, sc.depth, sc.octree_scale,
                torch.cat([r[0] for r in rays]).contiguous(), torch.cat([r[1] for r in rays]).contiguous())

    # K1 on the terrain primaries (the forward and fwd+bwd paths' shape)
    prim = primaries(scene, cam, WIDTH, HEIGHT)
    k_res = traverse(*prim)
    err_k1 = max(err_k1, compare_hits(k_res, traverse_reference(*prim), f"K1, depth-{DEPTH} terrain, {WIDTH}x{HEIGHT} primaries"))
    bound_ms, bound_by, fetches = traversal_bound(k_res)
    results["esvo_traverse"] = dict(
        max_abs_err=err_k1, ms=cuda_ms(lambda: traverse(*prim), 50),
        plain_ms=cuda_ms(lambda: traverse_reference(*prim), 3), bound_ms=bound_ms, bound_by=bound_by)
    log(f"  K1 {results['esvo_traverse']['ms']!r} ms, twin {results['esvo_traverse']['plain_ms']!r} ms, "
        f"bound {bound_ms!r} ms ({bound_by}: {fetches} node rows fetched, max {int(k_res.steps)} per ray) "
        f"on the {WIDTH}x{HEIGHT} depth-{DEPTH} primaries [{card}]")

    # P2 on the bench's uniform block and on a ragged size, bit for bit
    n_block = WIDTH * HEIGHT * N_BOUNCES * 21
    err_p2 = 0.0
    for n in (n_block, n_block - 3, 1001):
        got = philox_uniforms(12345, 7, n, dev)
        want = philox_uniforms_reference(12345, 7, n, dev)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err_p2 = max(err_p2, float((got - want).abs().max()))
        log(f"  P2 n={n}: bit-equal {equal}, range [{float(got.min())!r}, {float(got.max())!r}), "
            f"mean {float(got.mean())!r}")
        if not equal or float(got.max()) >= 1.0 or float(got.min()) < 0.0:
            raise AssertionError(f"P2 disagrees with its twin at n={n}")
    p2_bound = bound(4 * n_block, (n_block // 4) * PHILOX_OPS_PER_BLOCK)
    results["philox_uniforms"] = dict(
        max_abs_err=err_p2, ms=cuda_ms(lambda: philox_uniforms(12345, 7, n_block, dev), 200),
        plain_ms=cuda_ms(lambda: philox_uniforms_reference(12345, 7, n_block, dev), 10),
        bound_ms=p2_bound[0], bound_by=p2_bound[1],
        library_ms=cuda_ms(lambda: torch.rand((WIDTH * HEIGHT, N_BOUNCES, 21), device=dev), 200))
    log(f"  P2 {results['philox_uniforms']['ms']!r} ms, twin {results['philox_uniforms']['plain_ms']!r} ms, "
        f"torch.rand {results['philox_uniforms']['library_ms']!r} ms, bound {p2_bound[0]!r} ms ({p2_bound[1]}) "
        f"on the ({WIDTH * HEIGHT}, {N_BOUNCES}, 21) block [{card}]")

    # K2 on the cutout scene: the 256^2 primaries, then the training views
    cut_tables = accept_tables(cut)
    cprim = primaries(cut, cut_cam, WIDTH, HEIGHT)
    err_k2 = compare_hits(traverse_alpha(*cprim, cut_tables), traverse_alpha_reference(*cprim, cut_tables),
                          f"K2, depth-{DEPTH} cutout, {WIDTH}x{HEIGHT} primaries")
    k2_256 = (cuda_ms(lambda: traverse_alpha(*cprim, cut_tables), 50),
              cuda_ms(lambda: traverse_alpha_reference(*cprim, cut_tables), 3))
    log(f"  K2 {k2_256[0]!r} ms, twin {k2_256[1]!r} ms on the {WIDTH}x{HEIGHT} cutout primaries [{card}]")
    ctrain = training_rays(cut)
    k_res = traverse_alpha(*ctrain, cut_tables)
    err_k2 = max(err_k2, compare_hits(k_res, traverse_alpha_reference(*ctrain, cut_tables),
                                      f"K2, depth-{DEPTH} cutout, {TRAIN_VIEWS} training views at {TRAIN_RES}^2"))
    bound_ms, bound_by, fetches = traversal_bound(k_res)
    results["esvo_traverse_alpha"] = dict(
        max_abs_err=err_k2, ms=cuda_ms(lambda: traverse_alpha(*ctrain, cut_tables), 10),
        plain_ms=cuda_ms(lambda: traverse_alpha_reference(*ctrain, cut_tables), 1),
        bound_ms=bound_ms, bound_by=bound_by)
    log(f"  K2 {results['esvo_traverse_alpha']['ms']!r} ms, twin {results['esvo_traverse_alpha']['plain_ms']!r} ms, "
        f"bound {bound_ms!r} ms ({bound_by}: {fetches} node rows) on the cutout training views [{card}]")

    # K3r on both scenes: the 256^2 primaries, then the training views
    terrain_tables = accept_tables(scene)
    err_k3 = 0.0
    for label, rays, tables in (("terrain", prim, terrain_tables), ("cutout", cprim, cut_tables)):
        k_res, k_rec = traverse_record(*rays, tables)
        r_res, r_rec = traverse_record_reference(*rays, tables)
        err_k3 = max(err_k3, compare_hits(k_res, r_res, f"K3r, depth-{DEPTH} {label}, {WIDTH}x{HEIGHT} primaries", k_rec, r_rec))
        log(f"  K3r {cuda_ms(lambda: traverse_record(*rays, tables), 50)!r} ms, twin "
            f"{cuda_ms(lambda: traverse_record_reference(*rays, tables), 3)!r} ms on the {WIDTH}x{HEIGHT} "
            f"{label} primaries; surfaces per ray {torch.bincount(k_rec.count).tolist()} [{card}]")
    k3 = {}
    for label, rays, tables in (("terrain", training_rays(scene), terrain_tables), ("cutout", ctrain, cut_tables)):
        k_res, k_rec = traverse_record(*rays, tables)
        r_res, r_rec = traverse_record_reference(*rays, tables)
        err_k3 = max(err_k3, compare_hits(k_res, r_res, f"K3r, depth-{DEPTH} {label}, {TRAIN_VIEWS} training views at {TRAIN_RES}^2", k_rec, r_rec))
        k3[label] = (rays, tables, k_res)
    rays, tables, k_res = k3["terrain"]
    bound_ms, bound_by, fetches = traversal_bound(k_res, RECORD_BYTES)
    results["esvo_traverse_record"] = dict(
        max_abs_err=err_k3, ms=cuda_ms(lambda: traverse_record(*rays, tables), 10),
        plain_ms=cuda_ms(lambda: traverse_record_reference(*rays, tables), 1),
        bound_ms=bound_ms, bound_by=bound_by)
    log(f"  K3r {results['esvo_traverse_record']['ms']!r} ms, twin {results['esvo_traverse_record']['plain_ms']!r} ms, "
        f"bound {bound_ms!r} ms ({bound_by}: {fetches} node rows) on the terrain training views [{card}]")
    del k3, ctrain, rays, tables

    # K3s on shadow rays from the cutout primaries' hit points: toward the sun
    # (strict, no t) and toward sampled emitter points (t recorded)
    po, pd = cprim[4], cprim[5]
    first = traverse_alpha(*cprim, cut_tables)
    hn = face_normals(dev)[first.face_id.clamp(0, 5).long()]
    hp = torch.where(first.hit[:, None], po + pd * first.t[:, None], po)
    su = torch.from_numpy(np.random.default_rng(11).random((WIDTH * HEIGHT, 5), dtype=np.float32)).to(dev)
    sun_dir = random_sun_direction(cut.sun, su[:, 0], su[:, 1]).contiguous()
    front = (sun_dir * hn).sum(-1) > 0.0
    air = torch.zeros((WIDTH * HEIGHT,), dtype=torch.int32, device=dev)
    cut_em = with_emitter_sampling(cut, "one").emitters
    smp = sample_emitter_point(cut_em, hp, su[:, 2], su[:, 3], su[:, 4], n=hn)
    to_q = smp["q"] - hp
    dist = torch.sqrt(torch.clamp((to_q * to_q).sum(-1), min=1e-14))
    wi = (to_q / dist[:, None]).contiguous()
    em_on = first.hit & ((wi * hn).sum(-1) > 0.0) & ((-wi * smp["ne"]).sum(-1) > 0.0)
    walks = {
        "sun": ((torch.where(front[:, None], hp, hp - OFFSET * hn) + sun_dir * OFFSET).contiguous(),
                sun_dir, first.hit & front, True, False),
        "emitter": ((hp + wi * OFFSET).contiguous(), wi, em_on, False, True),
    }
    err_k3s = 0.0
    for label, (so, sd, sa, strict, record_t) in walks.items():
        sargs = (cut.nodes, cut.root, cut.depth, cut.octree_scale, so, sd, cut_tables, air, strict, record_t,
                 1024.0, sa)
        k_res, k_st = traverse_shadow(*sargs)
        r_res, r_st = traverse_shadow_reference(*sargs)
        err_k3s = max(err_k3s, compare_hits(k_res, r_res, f"K3s {label} walk, depth-{DEPTH} cutout, "
                                            f"{int(sa.sum())} of {WIDTH}x{HEIGHT} lanes active"))
        unequal = {f: int((getattr(k_st, f) != getattr(r_st, f)).sum())
                   for f in k_st._fields if getattr(k_st, f) is not None}
        if record_t:  # the emitter walk's attenuation, truncated short of the light
            max_t = dist * (1.0 - 1e-3)
            k_att = pathtracer._stateful_att_from_state(cut, air, k_st, max_t, strict)
            r_att = pathtracer._stateful_att_from_state(cut, air, r_st, max_t, strict)
            unequal["attenuation"] = int((k_att != r_att).sum())
        log(f"    record not bit-equal: {unequal}; surfaces per ray {torch.bincount(k_st.count).tolist()}; "
            f"budget spent on {int((k_st.w <= 0).sum())} lanes")
        if any(unequal.values()):
            raise AssertionError(f"K3s's record disagrees with its twin on the {label} walk")
        if label == "sun":
            sun_args, sun_res = sargs, k_res
        else:
            em_ms = (cuda_ms(lambda: traverse_shadow(*sargs), 50),
                     cuda_ms(lambda: traverse(*sargs[:6], 1024.0, sargs[-1]), 50),
                     cuda_ms(lambda: traverse_alpha(*sargs[:6], cut_tables, 1024.0, sargs[-1]), 50))
            log(f"  K3s {em_ms[0]!r} ms; on the same rays K1 {em_ms[1]!r} ms, K2 {em_ms[2]!r} ms; "
                f"the {WIDTH}x{HEIGHT} cutout emitter walk, bound {traversal_bound(k_res, SHADOW_BYTES + SHADOW_T_BYTES)[0]!r} ms "
                f"[{card}]")
    bound_ms, bound_by, fetches = traversal_bound(sun_res, SHADOW_BYTES)
    results["esvo_traverse_shadow"] = dict(
        max_abs_err=err_k3s, ms=cuda_ms(lambda: traverse_shadow(*sun_args), 50),
        plain_ms=cuda_ms(lambda: traverse_shadow_reference(*sun_args), 3), bound_ms=bound_ms, bound_by=bound_by)
    same_rays = sun_args[:6] + (1024.0,)
    k1_same = cuda_ms(lambda: traverse(*same_rays, sun_args[-1]), 50)
    k2_same = cuda_ms(lambda: traverse_alpha(*same_rays[:6], cut_tables, 1024.0, sun_args[-1]), 50)
    log(f"  K3s {results['esvo_traverse_shadow']['ms']!r} ms, twin {results['esvo_traverse_shadow']['plain_ms']!r} ms, "
        f"bound {bound_ms!r} ms ({bound_by}: {fetches} node rows); on the same rays K1 {k1_same!r} ms, "
        f"K2 {k2_same!r} ms; the {WIDTH}x{HEIGHT} cutout sun walk [{card}]")

    # P1 at the probe's shape, then at the emitter grid's on the cutout's
    # supercells of its primaries' hit points (as _spatial_pick computes them)
    g = torch.Generator().manual_seed(3)
    probe = torch.randint(-2**31, 2**31 - 1, (1 << 17, 8), generator=g, dtype=torch.int32).to(dev)
    probe_idx = torch.randint(0, 1 << 17, (4096,), generator=g, dtype=torch.int32).to(dev)
    gsz = 1 << cut_em.grid_bits
    cell = torch.clamp(((hp + (0.01 * cut_em.cell_size) * hn) / cut_em.cell_size).to(torch.int32), 0, gsz - 1)
    cells = ((cell[:, 0] * gsz + cell[:, 1]) * gsz + cell[:, 2]).contiguous()
    gathers = (("the probe's (131072, 8) int32 table, 4096 indices", probe, probe_idx),
               (f"grid_idx {tuple(cut_em.grid_idx.shape)} int32, {cells.numel()} indices", cut_em.grid_idx, cells),
               (f"grid_w {tuple(cut_em.grid_w.shape)} float32, {cells.numel()} indices", cut_em.grid_w, cells))
    for label, table, idx in gathers:
        got, want = row_gather(table, idx), row_gather_reference(table, idx)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
        idx_long = idx.long()
        p1 = dict(
            max_abs_err=float((got.view(torch.int32) != want.view(torch.int32)).sum()),
            ms=cuda_ms(lambda t=table, i=idx: row_gather(t, i), 200),
            plain_ms=cuda_ms(lambda t=table, i=idx: row_gather_reference(t, i), 200),
            library_ms=cuda_ms(lambda t=table, i=idx_long: torch.index_select(t, 0, i), 200))
        p1["bound_ms"], p1["bound_by"] = gather_bound(table, idx.numel())
        log(f"  P1 {label}: bit-equal {equal}; {p1['ms']!r} ms, twin {p1['plain_ms']!r} ms, "
            f"torch.index_select {p1['library_ms']!r} ms, bound {p1['bound_ms']!r} ms ({p1['bound_by']}) [{card}]")
        if not equal:
            raise AssertionError(f"P1 disagrees with its twin on {label}")
    results["row_gather"] = p1  # the main path's shape: grid_w over the 256^2 lanes
    del walks, sun_args, sun_res, first, probe, probe_idx

    # ---- 3. the forward main path: the progressive renderer
    log("phase 3 forward main path (Renderer):")
    passes = []
    real_pass, real_branched = renderer.render_pass, renderer.render_pass_branched

    def count_pass(*a, **kw):
        passes.append(("render_pass", a[8]))
        return real_pass(*a, **kw)

    def count_branched(*a, **kw):
        passes.append(("render_pass_branched", a[8]))
        return real_branched(*a, **kw)

    r = Renderer(scene=scene, camera=cam, width=WIDTH, height=HEIGHT, n_bounces=N_BOUNCES,
                 branch_count=10, target_spp=20, seed=0)
    reset_counts(wrappers.values())
    t0 = time.perf_counter()
    with mock.patch.object(renderer, "render_pass", count_pass), \
            mock.patch.object(renderer, "render_pass_branched", count_branched):
        while r.step():
            torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    read_counts("the Renderer", ("esvo_traverse", "philox_uniforms"))
    frame = r.framebuffer
    log(f"  passes {passes}; spp {r.spp}; {render_s:.2f} s")
    if r.spp != 20 or {p[0] for p in passes} != {"render_pass", "render_pass_branched"}:
        raise AssertionError(f"renderer did not run both pass kinds to 20 spp: {passes}")
    if not bool(torch.isfinite(frame).all()) or float(frame.mean()) <= 0.0:
        raise AssertionError("rendered frame is not finite with a positive mean")
    ppm = save_image(os.path.join(out_dir, f"chunk_d{DEPTH}_{WIDTH}.ppm"), frame)
    log(f"  frame mean {float(frame.mean())!r}, finite; wrote {os.path.relpath(ppm)}")

    # ---- 3b. the light-sampling entry point
    argv = ["render", "--scene", "cutout", "--depth", str(DEPTH), "--width", str(WIDTH), "--height", str(HEIGHT),
            "--spp", "20", "--sun", "high_quality", "--emitter-sampling", "one", "--device", "cuda",
            "-o", os.path.join(out_dir, f"cutout_d{DEPTH}_{WIDTH}_nee.ppm")]
    log(f"phase 3b light sampling: cli {' '.join(argv)}")
    parsed = cli.build_parser().parse_args(argv)
    reset_counts(wrappers.values())
    t0 = time.perf_counter()
    r = parsed.fn(parsed)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    read_counts("cli render --sun high_quality --emitter-sampling one",
                ("esvo_traverse_alpha", "esvo_traverse_shadow", "row_gather", "philox_uniforms"))
    frame = r.framebuffer
    if r.spp != 20 or not bool(torch.isfinite(frame).all()) or float(frame.mean()) <= 0.0:
        raise AssertionError("the light-sampling frame is not finite with a positive mean at 20 spp")
    log(f"  spp {r.spp}; frame mean {float(frame.mean())!r}, finite; {r.scene.emitters.count} emitters; "
        f"{render_s:.2f} s with the scene build [{card}]")

    # ---- 4. frame parity: kernel paths against twin paths
    w = h = 64
    u = torch.from_numpy(np.random.default_rng(7).random((w * h, N_BOUNCES, 21), dtype=np.float32)).to(dev)
    for label, sc, camera in (("terrain", scene, cam), ("cutout", cut, cut_cam),
                              ("terrain HIGH_QUALITY + ONE", high_quality(scene, "one"), cam),
                              ("cutout HIGH_QUALITY + ONE", high_quality(cut, "one"), cut_cam)):
        po, pd = pixel_grid_rays(camera, w, h)
        got = trace_paths(sc, po, pd, u)
        with twins():
            want = trace_paths(sc, po, pd, u)
        bad = int((~torch.isclose(got, want, rtol=2e-3, atol=2e-3).all(dim=-1)).sum())
        log(f"phase 4 frame parity, {label} {w}x{h}x{N_BOUNCES}: bad lanes {bad}/{w * h}, "
            f"max abs diff {float((got - want).abs().max())!r}")
        if bad > 0.001 * w * h or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"kernel frame disagrees with the twin frame ({label})")

    # ---- 5. timing of the forward frame
    fo, fd = pixel_grid_rays(cam, WIDTH, HEIGHT)
    fu = pathtracer.draw_uniforms(1, 0, WIDTH * HEIGHT, N_BOUNCES, dev)
    _, live = trace_paths_census(scene, fo, fd, fu)
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace_paths(scene, fo, fd, fu)
        torch.cuda.synchronize()
        if i:  # the first run is the warm-up
            times.append((time.perf_counter() - t0) * 1e3)
    frame_ms = statistics.median(times)
    rays_nominal = WIDTH * HEIGHT * N_BOUNCES
    rays_live = int(live.sum())
    log(f"phase 5 forward timing [{card}]")
    log(f"  frame_ms {frame_ms!r} (median of {len(times)}: {[round(t, 3) for t in times]}) "
        f"depth {DEPTH} {WIDTH}x{HEIGHT} bounces {N_BOUNCES} [{card}]")
    log(f"  rays_nominal {rays_nominal} rays_per_s_nominal {rays_nominal / (frame_ms / 1e3)!r} [{card}]")
    log(f"  rays_live {rays_live} live_per_bounce {live.tolist()} "
        f"rays_per_s_live {rays_live / (frame_ms / 1e3)!r} [{card}]")

    # ---- 6. bench.py's fwd+bwd step
    log(f"phase 6 fwd+bwd (bench.py:61-71) [{card}]")

    def fwdbwd(sc, o, d, uu):
        p = {"atlas": sc.atlas.detach().clone().requires_grad_(True),
             "emittance": sc.materials.emittance.detach().clone().requires_grad_(True)}
        loss = trace_paths(apply_params(sc, p), o, d, uu).mean()
        loss.backward()
        return loss.detach(), p["atlas"].grad, p["emittance"].grad

    reset_counts(wrappers.values())
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g_atlas, g_emit = fwdbwd(scene, fo, fd, fu)
        torch.cuda.synchronize()
        if i:  # the first run is the warm-up
            times.append((time.perf_counter() - t0) * 1e3)
    read_counts("the fwd+bwd step", ("esvo_traverse",))
    fwdbwd_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated(dev)
    if not (bool(torch.isfinite(g_atlas).all()) and bool(torch.isfinite(g_emit).all())
            and float(g_atlas.abs().max()) > 0 and float(g_emit.abs().max()) > 0):
        raise AssertionError("fwd+bwd gradients are not finite and nonzero")
    log(f"  fwdbwd_ms {fwdbwd_ms!r} (median of {len(times)}: {[round(t, 3) for t in times]}) "
        f"depth {DEPTH} {WIDTH}x{HEIGHT} bounces {N_BOUNCES}; loss {float(loss)!r} [{card}]")
    log(f"  rays_per_s_fwdbwd_nominal {rays_nominal / (fwdbwd_ms / 1e3)!r} "
        f"rays_per_s_fwdbwd_live {rays_live / (fwdbwd_ms / 1e3)!r} [{card}]")
    log(f"  max_memory_allocated {peak} bytes ({peak / 2**20:.1f} MiB) [{card}]")

    po, pd = pixel_grid_rays(cam, w, h)
    got = fwdbwd(scene, po, pd, u)
    with mock.patch.object(pathtracer, "traverse", traverse_reference):
        want = fwdbwd(scene, po, pd, u)
    for name, g, wg in zip(("loss", "atlas", "emittance"), got, want):
        torch.testing.assert_close(g, wg, rtol=1e-5, atol=1e-7, msg=lambda m, name=name: f"{name}: {m}")
    log(f"  gradient through the kernels = through the twins at {w}x{h} (rtol 1e-5, atol 1e-7): "
        f"atlas max abs diff {float((got[1] - want[1]).abs().max())!r}, "
        f"emittance max abs diff {float((got[2] - want[2]).abs().max())!r}")

    # ---- 6b. bench.py's NEE and cutout lines and BASELINE's config 3
    log(f"phase 6b light sampling at bench.py's shapes [{card}]: emitters E = "
        f"{high_quality(scene, 'one').emitters.count} (depth-{DEPTH} terrain), "
        f"{high_quality(cut, 'one').emitters.count} (depth-{DEPTH} cutout)")
    for name, which, sampling in LIGHT_CELLS:
        sc = high_quality(scene if which == "terrain" else cut, sampling)
        camera = cam if which == "terrain" else cut_cam
        lo, ld = pixel_grid_rays(camera, WIDTH, HEIGHT)
        required = (("esvo_traverse",) if which == "terrain" else ("esvo_traverse_alpha", "esvo_traverse_shadow"))
        required += ("row_gather",) if sampling == "one" else ()
        _, live = trace_paths_census(sc, lo, ld, fu)
        rays_live = int(live.sum())
        for step, fn in (("forward", lambda: trace_paths(sc, lo, ld, fu)),
                         ("fwd+bwd", lambda: fwdbwd(sc, lo, ld, fu))):
            reset_counts(wrappers.values())
            torch.cuda.reset_peak_memory_stats(dev)
            times = []
            for i in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                if i:  # the first run is the warm-up
                    times.append((time.perf_counter() - t0) * 1e3)
            read_counts(f"the {name} line, {step}", required)
            if step == "fwd+bwd" and not all(bool(torch.isfinite(x).all()) for x in out):
                raise AssertionError(f"the {name} line's loss or gradients are not finite")
            ms = statistics.median(times)
            log(f"  {name} {step}_ms {ms!r} (median of {len(times)}: {[round(t, 3) for t in times]}) "
                f"{which} HIGH_QUALITY emitters={sampling} depth {DEPTH} {WIDTH}x{HEIGHT} bounces {N_BOUNCES}; "
                f"rays_per_s_nominal {rays_nominal / (ms / 1e3)!r} rays_per_s_live {rays_live / (ms / 1e3)!r} "
                f"(live per bounce {live.tolist()}); max_memory_allocated "
                f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB [{card}]")

    # ---- 7. the training entry point
    for scene_name, required in (("chunk", ("esvo_traverse", "esvo_traverse_record", "philox_uniforms")),
                                 ("cutout", ("esvo_traverse_alpha", "esvo_traverse_record", "philox_uniforms"))):
        out = os.path.join(out_dir, f"params_{scene_name}.npz")
        argv = ["train", "--scene", scene_name, "--depth", str(DEPTH), "--views", str(TRAIN_VIEWS),
                "--width", str(TRAIN_RES), "--height", str(TRAIN_RES), "--steps", str(TRAIN_STEPS),
                "--device", "cuda", "-o", out]
        log(f"phase 7 training: cli {' '.join(argv)}")
        parsed = cli.build_parser().parse_args(argv)
        reset_counts(wrappers.values())
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = parsed.fn(parsed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        read_counts(f"cli train --scene {scene_name}", required)
        saved = load_arrays(out)
        if not all(np.isfinite(res.losses)) or len(res.losses) != TRAIN_STEPS:
            raise AssertionError(f"training losses not finite: {res.losses}")
        if saved["atlas"].shape != tuple(res.params["atlas"].shape) or not np.isfinite(saved["atlas"]).all():
            raise AssertionError("trained parameters were not written")
        log(f"  losses {res.losses}; wall s per step {res.step_seconds}; whole command {wall:.2f} s; "
            f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB [{card}]")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=main_path_launches[name], library_ms=None)
        row.update(results[name])
        kernels.append(row)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
