#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``octree_pathtracing_tpu_torch``) on
one NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

0. two host processes start at once and run beside phases 1-2: one
   synthesizes the survival region of phase 8, the other builds the BVH of
   the depth-9 plant field's quad soup (about a minute of numpy on one
   core; cached under ``build/`` for the same soup);
1. the card's name and power limit; build the kernels from the sources in
   this checkout, one nvcc per source, started together: the traversal
   (``csrc/traversal.cu``: K1, K2 alpha accept, K3r recording walk, K3s
   shadow walk, and K2q, their block-model variant), K7
   (``csrc/prims.cu``, the analytic-primitive scan), K8 (``csrc/bvh.cu``,
   the BVH walk over quads), P2 (``csrc/uniforms.cu``, Philox uniforms),
   P1 (``csrc/gather.cu``, row gather), K4 (``csrc/shade.cu``, hit
   resolve and shade, forward and backward), K4's next-event half with
   K6 (``csrc/nee.cu``: ``nee_setup``, ``nee_resolve``, ``nee_backward``)
   K5 (``csrc/compact.cu``: ``compact_forward``, ``compact_backward``,
   the unpermute and its backward) and K10 (``csrc/preview.cu``, the
   preview's resolve and flat shade); and, beside them, the C++ region
   parser with g++ (host code: where it does not build, the numpy parser
   reads regions, as in the JAX package, and the line says why); ptxas's
   report of every kernel (registers, stack frame, spills), the
   traversal's shared-memory stack, and K4's launch configuration (blocks,
   shared memory per block, resident blocks per SM, where its tables are
   read, registers and stack frame) at the headline's 65,536 and 4,072
   lanes, for both variants of its forward (the terrain's, and the
   analytic scene's with K7's scan folded in), and ``nee_setup``'s
   registers with and without the scan;
2. every kernel against its plain-torch twin on the card, timed beside its
   bound twice, by call (CUDA events around back-to-back calls: what an
   eager caller pays, host path included) and on the device alone (the same
   calls captured in a CUDA graph and replayed); P1 and P2 beside the same
   two times of ``torch.index_select`` and ``torch.rand``:
   - K1 on a random depth-4 octree (4096 rays with an active mask), on
     the 256x256 primaries of the depth-9 terrain and on bounces 2-5 of
     one headline frame (phase 5's uniforms: the whole batch, K5's live
     lanes first, with its active mask);
   - P2 on the (65536, 5, 21) uniform block and on ragged sizes (one not a
     multiple of the grid's stride), bit for bit;
   - K2 on the 256x256 primaries of the depth-9 cutout scene and on its
     8 training views at 512x512; K3r on the 256x256 primaries of both
     depth-9 scenes and on the 8 training views of both;
   - K3s on shadow rays from the hit points of the depth-9 cutout's 256x256
     primaries: toward sun directions drawn by ``random_sun_direction``
     (strict, no t), and toward ``sample_emitter_point`` points (t
     recorded, the attenuation truncated at ``max_t``); beside K1 on the
     same rays;
   - P1 at the probe's shape (a (131072, 8) int32 table, 4096 int32 and
     int64 indices) and at the emitter grid's (the cutout's (4096, 8)
     ``grid_idx`` and ``grid_w`` at the 65536 supercells of its primaries'
     hit points), one table at a time and both in one launch
     (``row_gather_pair``, the emitter pick's gathers until K6 moved into
     ``nee_setup``: P1 is on no main path since), bit for bit, beside
     ``torch.index_select``.
   - K2q in each of its modes on ``plant_scene(depth=9)``: modes 1 and 2 on
     the 256x256 primaries, mode 3 on shadow rays from their hits toward
     sun directions (strict, no t) and toward random directions of the hit
     face's hemisphere (t recorded); K7 on the 256x256 primaries of
     ``analytic_sphere_scene(depth=9)``; both by call and on the device.
   - K8 on the plant field's 65,025 plants as a world-space soup of 260,100
     quads (``build_bvh``, leaves of 2), against the 256x256 plant
     primaries, without and with a ``t_init`` (the octree hit's t): hit, t
     and payload bit for bit, by call and on the device, with its launch
     (the stack's entries in shared memory, registers, stack frame), the
     node rows it reads a ray (the root's and two per expansion) and two
     bounds from the twin's walk: those rows, and the rows with the twin's
     re-read on every pop; then K8's main path, one ``bvh_intersect_quads``
     call through the entry point.
   - K4's forward and backward on the lanes of each bounce of one headline
     frame (the 65,536 primaries, then bounces 2-5's whole batches, their
     live lanes first and their dead lanes passed through; the backward of
     bounces 2-5 also as the main path calls it, storing through the
     compaction's ``src``, bit-equal to its stores in place moved back):
     every output and the residual within rtol 1e-5 / atol 1e-6 of the
     twin on all but 0.1% of the lanes (the lanes not bit-equal counted
     field by field), the backward (on the kernel's forward outputs) within
     rtol 1e-5 / atol 1e-7 of the backward twin; by call and on the device,
     each row with the variant its launch took, the backward through
     ``src`` with its own bound.  Bounce 5 as the main path shades it: K4
     given the compaction's ``idx`` stores the frame's radiance in the
     lanes' order (the final unpermute folded in), and its backward reads
     the cotangent there; both bit for bit against K4 in row order with the
     standalone ``unpermute_kernel`` (its gather for the backward), timed
     beside that route with their own bounds (the row ``shade (unpermute
     stores)``); the same for ``nee_resolve`` and ``nee_backward`` on the
     NEE line's last bounce (``nee_resolve (unpermute stores)``).
   - K4's forward with K7's scan folded in on the lanes of each bounce of
     one frame of the depth-9 analytic scene (IMPORTANCE, 65,536 lanes):
     against its twin (which scans with K7's plain version) under K4's
     gate, and bit for bit against K4 fed by the standalone K7; by call and
     on the device beside its bound, its twin and that route's times.
   - K4's next-event half on the bounce-1 lanes of the NEE, cutout and
     config-3 lines (the world's in phase 8), ``utils/timing.check_nee``:
     ``nee_setup`` against its plain version on every ray field,
     ``nee_resolve`` on the radiance and the residual, each bit-equal on all
     but 0.1% of the rows and within rtol 1e-5 / atol 1e-6 there;
     ``nee_backward`` on the cotangent the frame's backward hands the
     bounce, within rtol 1e-5 / atol 1e-7; by call and on the device,
     beside the plain versions and the bound (``nee_bounds``); the same on
     the analytic HIGH_QUALITY line, where ``nee_setup`` scans each cast
     ray (K7's scan folded in): its primitive slots bit-equal to the
     standalone K7 on every cast row and within K7's gate of K7's plain
     version, timed beside ``nee_setup`` without the scan and K7 over its
     rays.
   - K5, ``utils/timing.check_compact``: ``compact_forward`` against
     ``compact_reference`` on every output (the state, the carried index,
     the bounce's uniforms, ``pos``, the live count), ``compact_backward``,
     the standalone unpermute and its backward (a direct caller's; no main
     path launches them) against theirs, all bit for bit, on the
     compactions of one headline frame (bounces 2-5), its bounce-2 state
     repeated to 1,048,576 and 2,097,152 lanes, a branched frame's 64x64 x
     10 lanes, 1 lane and a batch with no live lane; by call and on the
     device beside the byte bound, the plain version, a stable
     ``torch.argsort`` with one ``index_select`` per field, and the
     ``nonzero``, gathers and ``index_put``s that the main path ran before
     the kernel.
   Every traversal row carries the max, p50 and p99 of its per-ray fetch
   counts (whether its longest walk sets the call).  Every traversal result
   must equal its twin's on every lane and field bit for bit: hit, t, face,
   uv, leaf, voxel, fetch counts, records (K3s's count, w, medium, mats,
   uv, ts) and K2q's quad surfaces; K7's hit,
   material, t and normal bit for bit and its uv within 1e-6 (CUDA's acosf
   and atan2f may differ from PyTorch's by an ulp);
3. the forward main path: ``Renderer(256x256, 5 bounces, branch_count=10,
   target_spp=20)`` on ``minecraft_chunk_scene(depth=9)`` to the end —
   passes of 1, 1, 1, 1, 6 and 10 samples; the frame must be finite with a
   positive mean, and K1 and P2 must have been launched;
3b. the light-sampling entry point: ``cli render --scene cutout --depth 9
   --width 256 --height 256 --spp 20 --sun high_quality --emitter-sampling
   one --device cuda``; the frame must be finite with a positive mean, and
   K2, K3s, P2, K4 and its next-event kernels must have been launched,
   ``nee_setup`` and ``nee_resolve`` once per ``_shade`` call, P1 never;
3c. the block-model entry point: ``cli render --scene plant --depth 9
   --width 256 --height 256 --spp 20 --sun high_quality --device cuda``;
   the frame must be finite with a positive mean, and K2q (modes 1 and 3)
   and P2 must have been launched and no twin run;
3d. the preview at the reference window (``RenderConfig``'s 1280x720),
   depth 9: ``preview_image`` on the chunk (K1), the cutout (K2) and the
   plant field (K2q), and ``cli preview --world`` on phase 8's region;
   each must launch its walk and K10 once, and no twin; K10's output on
   that call equal to its twin's on every pixel bit for bit; the
   preview's eager ms (median of 5 after a warm-up), K10 by call and on
   the device (graph replays of the call repeated, its inputs in L2, and
   of 3 copies of its inputs in turn, read from HBM) beside its bound (the
   bytes the call's data needs: the hit flag and output of every pixel,
   the direction of a miss, the walk's fields of a hit, each distinct
   texel once, over the memory rate) and its twin;
3e. checkpoint and resume: ``cli render --scene chunk --depth 9`` at
   256x256 and 4 spp with ``--checkpoint``, then ``--resume`` to 8 spp:
   bit-equal to an uninterrupted 8-spp render;
4. frame parity: one 64x64, 5-bounce frame of each depth-9 scene from a
   fixed uniform block, through the kernels and through the twins, with the
   IMPORTANCE sun and with HIGH_QUALITY + ``EmitterSampling.ONE``, and of
   the plant field (HIGH_QUALITY) and the analytic scene (IMPORTANCE and
   HIGH_QUALITY); the twin side runs K4's and the next-event half's plain
   versions with the traversal's and K7's twins; per-lane rtol and atol
   2e-3, no lane outside;
5. timing of the forward frame (256x256, 5 bounces, median of 5 after a
   warm-up), with nominal and live rays per second, and its launches
   (torch.profiler's device activities: kernels, fills and copies) through
   K4's kernels and through its eager twin;
6. bench.py's fwd+bwd step (``jax.grad`` of the mean radiance into atlas and
   emittance, bench.py:61-71) on the depth-9 terrain at 256x256 and
   5 bounces: median of 5 after a warm-up, rays/s, peak memory, its
   launches as phase 5's; and the
   gradient through the kernels against the gradient through the twins at
   64x64, per element within rtol 1e-5 / atol 1e-7 (the backward of the
   atlas gather accumulates in an order the card does not fix);
6a. the headline and the NEE line (terrain, HIGH_QUALITY) forward and
   fwd+bwd under ``torch.cuda.set_sync_debug_mode("error")``: nothing in a
   frame reads the card from the host; then the headline forward frame
   captured in a CUDA graph and replayed, bit-equal to the eager frame,
   its replay ms (the frame's device floor) beside phase 5's eager ms; and
   the headline's and config 3's fwd+bwd frames (``nee_backward``'s
   cooperative launch on every bounce of config 3) captured whole and
   replayed with their outputs spoiled: the radiance bit-equal to the eager
   frame's, the gradients within rtol 1e-5 / atol 1e-7, the replay ms
   beside the eager step's; the headline forward and fwd+bwd against the
   route before the folds (``utils/timing.unfolded``);
6b. bench.py's NEE line (terrain, HIGH_QUALITY: the binary shadow walk), its
   cutout line (cutout, HIGH_QUALITY: K3s) and BASELINE's config 3 (terrain
   with its glowstone emitters, HIGH_QUALITY + ``EmitterSampling.ONE``),
   each forward and fwd+bwd at phase 5's shape, with rays/s and peak
   memory and the launches per frame (torch.profiler) through the kernels
   and through the next-event half's plain version; the gradients must be
   finite, and at 64x64 equal to the gradients through the plain versions
   (rtol 1e-5, atol 1e-7); the emitter count of each scene;
6c. the block-model and primitive lines at phase 5's shape: the depth-9
   plant field under its HIGH_QUALITY sun (K2q's mode 1 for the bounces, its
   mode 3 for the sun walks) and the depth-9 analytic scene under
   IMPORTANCE and HIGH_QUALITY (K1; K7's scan inside K4's forward for each
   bounce and inside ``nee_setup`` for each shadow ray), forward and
   fwd+bwd, timed as phases 5 and 6, with their launches as phase 6b's and
   the analytic lines' forward frames replayed from CUDA graphs; K2q and
   K4's scanning variant must have been launched, the next-event kernels
   on the HIGH_QUALITY lines, and no twin run.  Every line of phases 6b,
   6c and 8d is also run through the route before the folds
   (``utils/timing.unfolded``): the forward radiance and the fwd+bwd loss
   bit for bit, the gradients within rtol 1e-5 / atol 1e-7 with the
   elements not bit-equal counted;
7. the training entry point: ``cli train`` (``inverse_render``, soft weight
   0.25) with the JAX CLI's defaults of 8 views at 512x512 for 3 steps, on
   ``--scene chunk --depth 9`` (K1, K3r, P2) and on ``--scene cutout
   --depth 9`` (K2, K3r, P2): finite losses, the parameters written, wall
   seconds per step; and ``cli train --scene plant --depth 9`` at 2 views
   of 128x128 for 2 steps (K2q in all three modes, P2);
8. the world path on a survival region synthesized from a fixed seed at
   the full size of one region file (32x32 chunks, sections -4..19, so
   512x384x512 blocks: terrain with ores, water, beaches, oak trees, glass,
   glowstone and lava), written to ``build/`` by ``make_region_fixture``:
   the file's size, the parser that read it and its seconds, the region
   octree's build, ``minecraft_scene_from_region`` and the scene's bytes on
   the card; (a) ``cli render --world ... --depth 9 --sun high_quality
   --emitter-sampling one`` at 256x256 and 20 spp; (b) ``cli info
   --world``; (c) frame parity at 64x64 as phase 4; (d) ``trace_paths`` at
   phase 5's shape, forward and fwd+bwd, timed as phase 6b, and the
   next-event kernels' phase-2 rows on its bounce-1 lanes; (e) ``cli
   train --world`` at 2 views of 128x128 for 2 steps.  The kernels each
   path must launch follow the scene's flags (the palette's textures are
   never transparent enough to reject a hit, so the bounces run K1; leaves,
   glass and water make the sun walks K3s);
9. the sharded steps: two ranks spawned by ``torch.multiprocessing``
   (gloo, ``tcp://localhost``) share the card, after phase 1 built every
   library; each runs ``sharded_rank`` on the headline (depth 9, 256x256
   lanes, S = 2 from P2, 5 bounces): ``sharded_render`` in the layouts
   (dp = 2, sp = 1) and (dp = 1, sp = 2), each equal to the unsharded
   ``trace_paths`` average within rtol and atol 1e-6; ``sharded_train_step``
   at S = 1 (dp = 2): the loss and gradients the same on both ranks and
   within rtol 1e-5 / atol 1e-7 of the unsharded step's; each rank's
   frame, all-reduce and step ms; the ranks' launches count with the main
   paths'.

The launch counts of the main paths (phases 3, 3b, 3c, 3d, 3e, 5, 6, 6a,
6b, 6c, 7, 8, 9 and K8's walk in phase 2) are
set to 0 just before each path and read just after; the kernels'
comparisons with their twins do not count.  Every path must have launched
K4's forward, and its backward where a gradient is taken, and no path may
run a twin (the twins' entry points are counted, K4's, the next-event
half's and K5's too); every light-sampling path must have launched ``nee_setup``
and ``nee_resolve``, and ``nee_backward`` where a gradient is taken; the
Renderer and every line of phases 5, 6, 6a, 6b, 6c and 8d K5's forward and
the last bounce's radiance stored at the lanes' index (K4's forward on a
scene that samples no light, ``nee_resolve`` on one that does), and with a
gradient that writer's backward reading the cotangent there and K4's
backward storing through the compaction's ``src`` (``nee_backward`` too on a
light line); every path on a scene with primitives K4's forward with K7's
scan (and ``nee_setup`` with it where the scene samples light).  No main
path may launch K7 (``prims_intersect``), ``compact_backward`` or the
unpermute either way: their work is folded into the kernels that read
their results, and phase 2 alone holds them against their plain
versions.  Each line prints its kernels, fills
and copies per frame (torch.profiler), held against the wrappers' own
counts over the same call: each session counts the second of two calls
(a session can drop the first activities after it starts), a session that
shows another number of the port's own kernels (by name,
``utils/timing.kernel_names``) than the wrappers launched dropped some, so
sessions go on until one shows them all, and a count that no session
completes is not printed; the headline's lines name PyTorch's kernels
beside them.  The
script names only the port; jax and the JAX package are blocked before
anything is imported.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it the card's name and power limit, and the one before
that the kernels' JSON line.  It exits non-zero without a CUDA card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import sys
import threading
import time
from collections import Counter
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
# K2q mode 1's quad surface out per lane: found, material, uv, normal, t
QUAD_OUT_BYTES = 1 + 4 + 8 + 12 + 4
# K2q, per candidate: the leaf's model id and the model's flags, start,
# count and face material (5 words); per quad tested one 84-byte row and,
# where it is hit, one texel alpha
MODEL_ROW_BYTES = 20
QUAD_ROW_BYTES = 84
OPS_PER_QUAD = 60  # a quad test: 3 dot products, 2 cross products, the division and compares
# K7, per lane: origin and direction in; hit, t, material, uv, normal out
PRIM_RAY_BYTES = 24 + 29
OPS_PER_SPHERE, OPS_PER_PRIM_QUAD = 45, 60
PHILOX_OPS_PER_BLOCK = 112  # 10 rounds of 2 mul-hi/lo pairs, 4 xor, 2 key adds; 4 float maps
# K8, per lane: origin and direction in; hit, t and payload out (33 B, and
# t_init's 4 B where given); per node row fetched 32 B, per interior node
# whose box is hit its two children's rows (64 B); per quad tested its row
BVH_RAY_BYTES = 24 + 9
BVH_NODE_BYTES = 32
OPS_PER_BOX = 30  # 6 subtractions, 6 multiplications, 12 min / max, 3 compares
# K4, per lane: the state (origin, dir, throughput, radiance, active,
# specular, medium) and the hit (hit, t, face, uv, leaf) in, the quad
# surface and the primitive hit where the scene has them; the state, the
# hand-off (albedo, hit point, normal, material, diffuse mask) and, with a
# gradient, the 24-byte residual out; the uniform words each lane reads
# (shade_bound); per distinct texel read 16 B, per distinct material row
# 28 B (7 columns)
SHADE_STATE_BYTES = 12 * 4 + 1 + 1 + 4
SHADE_IN_BYTES = SHADE_STATE_BYTES + 1 + 4 + 4 + 8 + 4
SHADE_OUT_BYTES = SHADE_STATE_BYTES + 16 + 12 + 12 + 4 + 1
SHADE_RESID_BYTES = 24
SHADE_QUAD_BYTES = SHADE_PRIM_BYTES = 1 + 4 + 8 + 12 + 4
SHADE_MAT_ROW_BYTES = 7 * 4
# K4's arithmetic per lane by what the lane does: resolve, texel and lobe
# choice; the sky and sun disk on a miss; a diffuse sample, and the sun
# importance warp (cap, remap, segment, redraws) where it is on; a specular
# or refracted direction
OPS_SHADE_LANE, OPS_SHADE_SKY, OPS_SHADE_DIFFUSE, OPS_SHADE_IMPORTANCE, OPS_SHADE_SPECULAR = 40, 40, 60, 200, 80
# the backward: ~40 operations per lane; its bytes, by the pointers a call
# passes and the lanes that need them, in shade_backward_bound
OPS_SHADE_BWD = 40
# nee_setup, per lane: the hand-off (hit point, normal, diffuse mask) and
# the medium in, the material on the sun face, the uniform words read; per
# face the ray out (origin, direction, max_t, scale, active, medium, the
# emitter's texel and material); the supercell rows the picks read and the
# emitter table, once each (nee_bounds)
NEE_SETUP_LANE_BYTES = 12 + 12 + 1 + 4
NEE_RAY_BYTES = 12 + 12 + 4 + 4 + 1 + 4 + 4 + 4
# with K7's scan folded in, per row its primitive slots: hit, t, material, uv
NEE_PRIM_SLOT_BYTES = 1 + 4 + 4 + 8
EMITTER_ROW_BYTES = 20
# nee_resolve, per lane: albedo, throughput, radiance and medium in, the
# radiance out; per face its active flag, per cast face max_t and scale (an
# emitter face's texel and material too), the walk's record and K7's hit;
# per distinct texel 16 B, per distinct emitter material 4 B; with a
# gradient 32 B of residual per face
NEE_RESOLVE_LANE_BYTES = 16 + 12 + 12 + 4 + 12
NEE_RESID_BYTES = 32
# nee_backward, per lane: the cotangent, the throughput and the albedo in,
# their gradients out; per face the residual's code, per cast face the rest
# of it and the scale; the texels it names; the dense gradients written once
NEE_BWD_LANE_BYTES = 12 + 12 + 16 + 12 + 16
# arithmetic: the sun face (cone sample, sinf / cosf, the tests), an
# emitter face (to_q, dist, wi, cosines, geom, texel), the spatial pick
# (cell, CDF walk, membership pdf, the face weights), per cast face in the
# resolve and per slot it folds; the backward per cast face and slot
OPS_NEE_SUN, OPS_NEE_FACE, OPS_NEE_PICK = 60, 50, 60
OPS_NEE_RESOLVE_FACE, OPS_NEE_SLOT, OPS_NEE_BWD_FACE, OPS_NEE_BWD_SLOT = 30, 15, 60, 25
# the synthesized survival region: 32 x 32 chunks, sections -4..19
WORLD_SEED, WORLD_CHUNKS = 2024, 32
WORLD_BLOCKS = ("air", "bedrock", "stone", "coal_ore", "iron_ore", "dirt", "grass_block", "sand", "water",
                "oak_log", "oak_leaves", "glass", "glowstone", "lava")
SEA_Y = 127  # the sea surface in region-local y (world y 63)
WORLD_DEPTH = 9  # a region is 512 blocks wide

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
    "esvo_traverse_models": ("octree_pathtracing_tpu_torch/csrc/traversal.cu",
                             "octree_pathtracing_tpu/render/hit.py:39"),
    "prims_intersect": ("octree_pathtracing_tpu_torch/csrc/prims.cu",
                        "octree_pathtracing_tpu/models/prims.py:71"),
    "bvh_intersect": ("octree_pathtracing_tpu_torch/csrc/bvh.cu",
                      "octree_pathtracing_tpu/ops/bvh.py:99"),
    "shade": ("octree_pathtracing_tpu_torch/csrc/shade.cu",
              "octree_pathtracing_tpu/render/pathtracer.py:1294"),
    # K4's forward and nee_setup with K7's scan folded in (their variants on
    # a scene with primitives): K7's work on the main paths
    "shade (K7 scan)": ("octree_pathtracing_tpu_torch/csrc/shade.cu",
                        "octree_pathtracing_tpu/models/prims.py:71"),
    "shade_backward": ("octree_pathtracing_tpu_torch/csrc/shade.cu",
                       "octree_pathtracing_tpu/render/pathtracer.py:804"),
    # K4's next-event half, K6's pick (models/emitters.py:161, :201, :270) inside nee_setup
    "nee_setup": ("octree_pathtracing_tpu_torch/csrc/nee.cu",
                  "octree_pathtracing_tpu/render/pathtracer.py:1361"),
    "nee_setup (K7 scan)": ("octree_pathtracing_tpu_torch/csrc/nee.cu",
                            "octree_pathtracing_tpu/models/prims.py:71"),
    "nee_resolve": ("octree_pathtracing_tpu_torch/csrc/nee.cu",
                    "octree_pathtracing_tpu/render/pathtracer.py:1390"),
    "nee_backward": ("octree_pathtracing_tpu_torch/csrc/nee.cu",
                     "octree_pathtracing_tpu/render/pathtracer.py:804"),
    # K5: _sort_state_by_active (:666) with the uniforms' gather (:891); its
    # VJP; the final .at[idx].set (:1016) and its VJP
    "compact_forward": ("octree_pathtracing_tpu_torch/csrc/compact.cu",
                        "octree_pathtracing_tpu/render/pathtracer.py:666"),
    "compact_backward": ("octree_pathtracing_tpu_torch/csrc/compact.cu",
                         "octree_pathtracing_tpu/render/pathtracer.py:666"),
    "unpermute": ("octree_pathtracing_tpu_torch/csrc/compact.cu",
                  "octree_pathtracing_tpu/render/pathtracer.py:1016"),
    "unpermute_backward": ("octree_pathtracing_tpu_torch/csrc/compact.cu",
                           "octree_pathtracing_tpu/render/pathtracer.py:1016"),
    # the last bounce's writer of the radiance with the unpermute folded into
    # its stores (and its backward's loads): the unpermute's work on the
    # main paths, K4's on a scene that samples no light, nee_resolve's on one
    # that does
    "shade (unpermute stores)": ("octree_pathtracing_tpu_torch/csrc/shade.cu",
                                 "octree_pathtracing_tpu/render/pathtracer.py:1016"),
    "nee_resolve (unpermute stores)": ("octree_pathtracing_tpu_torch/csrc/nee.cu",
                                       "octree_pathtracing_tpu/render/pathtracer.py:1016"),
    # K10: the preview's resolve, texel and flat shade or sky (render/preview.py:33-39, models/sun.py:219)
    "preview_shade": ("octree_pathtracing_tpu_torch/csrc/preview.cu",
                      "octree_pathtracing_tpu/render/preview.py:33"),
}
K5_KERNELS = ("compact_forward", "compact_backward", "unpermute", "unpermute_backward")
# what a fwd+bwd main path launches of K5 (compact_backward's work is in
# the stores of K4's backward and nee_backward)
K5_PATH = ("compact_forward", "shade_backward (src stores)")


def unpermute_fold(light: bool, grad: bool) -> tuple:
    """The counters a frame's last bounce must show where it stores the
    final radiance in the lanes' order (the unpermute folded in): K4's
    forward on a scene that samples no light, ``nee_resolve`` on one that
    does, and with a gradient their backwards reading the cotangent so."""
    writer = "nee_resolve" if light else "shade"
    reader = "nee_backward" if light else "shade_backward"
    return (f"{writer} (unpermute stores)",) + ((f"{reader} (unpermute reads)",) if grad else ())
# K5 per lane: the state's rows (origin, dir, throughput, radiance), flags
# (active, specular), medium and carried index, read once and written once;
# pos written; the bounce's 21 uniform words read and written
K5_STATE_BYTES = 48 + 2 + 4 + 4
K5_LANE_BYTES = 2 * K5_STATE_BYTES + 4 + 2 * 84
NEE_KERNELS = ("nee_setup", "nee_resolve", "nee_backward")
# K10, what a call's data needs: per pixel its hit flag and its output; per
# miss its direction; per hit its face, uv and leaf (and the quad flag on a
# scene with quad models); per quad hit the quad's material, uv and normal
PREVIEW_PIXEL_BYTES = 1 + 12
PREVIEW_MISS_BYTES = 12
PREVIEW_HIT_BYTES = 4 + 8 + 4
PREVIEW_QUAD_BYTES = 4 + 8 + 12
# phase 3d's frame: the reference window (RenderConfig's 1280x720)
PREVIEW_W, PREVIEW_H = 1280, 720
# phase 9: the sharded steps' samples per pixel (render, train step)
SHARD_S, SHARD_TRAIN_S = 2, 1
# the block-model and primitive lines at bench.py's shapes: (name, scene, sun)
MODEL_CELLS = (("plant", "plant", "high_quality"), ("analytic", "analytic", "importance"),
               ("analytic_hq", "analytic", "high_quality"))
# bench.py's lines and BASELINE's config 3 at bench.py's shapes:
# (name, scene, emitter sampling); every one runs the HIGH_QUALITY sun
LIGHT_CELLS = (("nee", "terrain", "none"), ("cutout", "cutout", "none"), ("config3", "terrain", "one"))
# the next-event kernels' phase-2 rows: (line, scene, emitter sampling), under the HIGH_QUALITY sun
NEE_ROW_LINES = (("nee", "terrain", "none"), ("cutout", "cutout", "none"), ("config3", "terrain", "one"))


# the host processes main() starts (the region synthesis, the BVH build)
CHILDREN = {}


_T0 = time.perf_counter()


def log(msg: str):
    """One line of the run's report; a phase's first line carries the
    seconds since the script started."""
    if msg.startswith("phase "):
        msg = f"{msg} [at {time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


def _smooth_noise(rng, w: int, cells: int):
    """A (w, w) field of unit-variance noise, bilinear over a coarse grid of
    ``cells`` per 512 blocks."""
    n = max(2, w * cells // 512)
    coarse = rng.standard_normal((n + 1, n + 1))
    f = np.arange(w) * (n / w)
    i = f.astype(np.int64)
    t = f - i
    row = coarse[i] * (1 - t)[:, None] + coarse[i + 1] * t[:, None]
    return row[:, i] * (1 - t)[None, :] + row[:, i + 1] * t[None, :]


def survival_grid(seed: int, n_chunks: int):
    """A (16 n, 384, 16 n) uint8 grid [x, y, z] of indices into WORLD_BLOCKS:
    a player's survival region.  A height field (sea level +3, hills of
    +-30) of bedrock, stone with coal and iron ore, three of dirt and a
    grass top; water to sea level in the valleys over sand beaches and
    floors; oak trees (log and leaves) on the grass; glass greenhouses, each
    round a glowstone; glowstone lamps and lava pools on the surface."""
    b = {n: i for i, n in enumerate(WORLD_BLOCKS)}
    rng = np.random.default_rng(seed)
    w = 16 * n_chunks
    h = SEA_Y + 3 + 22 * _smooth_noise(rng, w, 4) + 8 * _smooth_noise(rng, w, 16) + 2 * _smooth_noise(rng, w, 64)
    h = np.clip(np.round(h), 70, 250).astype(np.int64)
    xx, zz = np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
    y = np.arange(384, dtype=np.int64)[None, :, None]
    g = np.where(y <= h[:, None, :], np.uint8(b["stone"]), np.uint8(0))
    ore = rng.random(g.shape, dtype=np.float32)
    stone = g == b["stone"]
    g[stone & (ore < 0.01)] = b["coal_ore"]
    g[stone & (ore >= 0.01) & (ore < 0.016) & (y < 140)] = b["iron_ore"]
    del ore, stone
    g[:, 0, :] = b["bedrock"]
    g[:, 1:4, :][rng.random((w, 3, w)) < 0.4] = b["bedrock"]
    sandy = h <= SEA_Y + 1
    for k in range(4):
        g[xx, h - k, zz] = np.where(sandy, b["sand"], b["grass_block"] if k == 0 else b["dirt"])
    g[(y > h[:, None, :]) & (y <= SEA_Y)] = b["water"]
    for x, z in zip(*rng.integers(3, w - 3, (2, max(1, 300 * n_chunks * n_chunks // 1024)))):
        base = h[x, z]
        if g[x, base, z] != b["grass_block"]:
            continue
        top = base + int(rng.integers(4, 7))
        for ly in range(top - 2, top + 2):
            r = 2 if ly < top else 1
            crown = g[x - r : x + r + 1, ly, z - r : z + r + 1]
            crown[crown == 0] = b["oak_leaves"]
        g[x, base + 1 : top + 1, z] = b["oak_log"]
    for _ in range(max(1, n_chunks * n_chunks // 64)):
        x, z = rng.integers(4, w - 8, 2)
        base = int(h[x : x + 5, z : z + 5].max())
        g[x : x + 5, base + 1 : base + 5, z : z + 5] = b["glass"]
        g[x + 1 : x + 4, base + 1 : base + 4, z + 1 : z + 4] = 0
        g[x + 2, base + 1, z + 2] = b["glowstone"]
    for _ in range(max(1, n_chunks * n_chunks // 16)):
        x, z = rng.integers(2, w - 2, 2)
        g[x, h[x, z] + 1, z] = b["glowstone"]
    for _ in range(max(1, n_chunks * n_chunks // 128)):
        x, z = rng.integers(2, w - 5, 2)
        if h[x, z] > SEA_Y + 1:
            g[x : x + 3, h[x, z], z : z + 3] = b["lava"]
    return g


def write_survival_region(path: str, seed: int, n_chunks: int) -> dict:
    """Synthesize the region with ``make_region_fixture`` (every section of
    every chunk, each with its own palette and a plains biome) and write it
    to ``path``, unless a file of the same seed and size is there.  Returns
    {"path", "bytes", "voxels" (non-air blocks), "seconds"}."""
    from octree_pathtracing_tpu_torch.models import make_region_fixture

    t0 = time.perf_counter()
    meta = path + ".json"
    if os.path.exists(path) and os.path.exists(meta):
        with open(meta) as f:
            info = json.load(f)
        if (info.get("seed"), info.get("n_chunks")) == (seed, n_chunks):
            return dict(info, seconds=time.perf_counter() - t0, cached=True)
    g = survival_grid(seed, n_chunks)
    names = np.array([f"minecraft:{n}" for n in WORLD_BLOCKS])
    chunks = {}
    for cx in range(n_chunks):
        for cz in range(n_chunks):
            column = g[cx * 16 : cx * 16 + 16, :, cz * 16 : cz * 16 + 16]
            sections = {}
            for sy in range(24):
                block = column[:, sy * 16 : sy * 16 + 16, :].transpose(1, 2, 0).ravel()  # YZX
                ids, idx = np.unique(block, return_inverse=True)
                sections[sy - 4] = (list(names[ids]), idx.astype(np.uint16), "minecraft:plains")
            chunks[(cx, cz)] = sections
    buf = make_region_fixture(chunks)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(buf)
    info = dict(path=path, bytes=len(buf), voxels=int(np.count_nonzero(g)), seed=seed, n_chunks=n_chunks,
                counts={n: int(c) for n, c in zip(WORLD_BLOCKS, np.bincount(g.ravel(), minlength=len(WORLD_BLOCKS)))})
    with open(meta, "w") as f:
        json.dump(info, f)
    return dict(info, seconds=time.perf_counter() - t0, cached=False)


def build_plant_bvh(path: str, depth: int) -> dict:
    """``utils/timing.plant_bvh_file`` in a host process of its own: the
    BVH of ``plant_scene(depth)``'s quad soup, built or loaded from
    ``path``.  Returns {"plants", "quads", "seconds", "cached"}."""
    sys.modules["jax"] = None
    from octree_pathtracing_tpu_torch.utils.timing import plant_bvh_file

    return plant_bvh_file(path, depth)[0]


def _in_child(fn, out_json: str, *args):
    """Run ``fn(*args)`` in a child process, its result written as JSON."""
    result = fn(*args)
    with open(out_json, "w") as f:
        json.dump(result, f)


def counter_table() -> dict:
    """Each kernel's launch count as its wrapper keeps it: name -> (the
    wrapper, the attribute).  K2q's three modes count apart from K2, K3r and
    K3s in ``model_launches``."""
    from octree_pathtracing_tpu_torch.models.prims import intersect_prims
    from octree_pathtracing_tpu_torch.ops import compact as compact_mod
    from octree_pathtracing_tpu_torch.ops import nee as nee_mod
    from octree_pathtracing_tpu_torch.ops import shade as shade_mod
    from octree_pathtracing_tpu_torch.ops.bvh import bvh_intersect_quads
    from octree_pathtracing_tpu_torch.ops.gather import row_gather
    from octree_pathtracing_tpu_torch.ops.preview import preview_shade
    from octree_pathtracing_tpu_torch.ops.random import philox_uniforms
    from octree_pathtracing_tpu_torch.ops.traversal import traverse, traverse_alpha, traverse_record, traverse_shadow

    return {
        "esvo_traverse": (traverse, "launches"), "esvo_traverse_alpha": (traverse_alpha, "launches"),
        "esvo_traverse_record": (traverse_record, "launches"),
        "esvo_traverse_shadow": (traverse_shadow, "launches"),
        "philox_uniforms": (philox_uniforms, "launches"), "row_gather": (row_gather, "launches"),
        "esvo_traverse_models (mode 1)": (traverse_alpha, "model_launches"),
        "esvo_traverse_models (mode 2)": (traverse_record, "model_launches"),
        "esvo_traverse_models (mode 3)": (traverse_shadow, "model_launches"),
        "prims_intersect": (intersect_prims, "launches"),
        "bvh_intersect": (bvh_intersect_quads, "launches"),
        "shade": (shade_mod.shade, "launches"), "shade_backward": (shade_mod.shade, "backward_launches"),
        "nee_setup": (nee_mod.nee, "setup_launches"), "nee_resolve": (nee_mod.nee, "resolve_launches"),
        "nee_backward": (nee_mod.nee, "backward_launches"),
        "compact_forward": (compact_mod.compact, "launches"),
        "compact_backward": (compact_mod.compact, "backward_launches"),
        "unpermute": (compact_mod.unpermute, "launches"),
        "unpermute_backward": (compact_mod.unpermute, "backward_launches"),
        # the folds: of the launches above, K4's forward and nee_setup with
        # K7's scan inside, K4's backward and nee_backward storing through a
        # compaction's src (compact_backward's work)
        "shade (K7 scan)": (shade_mod.shade, "scan_launches"),
        "nee_setup (K7 scan)": (nee_mod.nee, "scan_setup_launches"),
        "shade_backward (src stores)": (shade_mod.shade, "src_backward_launches"),
        "nee_backward (src stores)": (nee_mod.nee, "src_backward_launches"),
        # the final unpermute: of the launches above, the last bounce's
        # writer of the radiance storing it at idx, its backward reading there
        "shade (unpermute stores)": (shade_mod.shade, "idx_launches"),
        "nee_resolve (unpermute stores)": (nee_mod.nee, "idx_resolve_launches"),
        "shade_backward (unpermute reads)": (shade_mod.shade, "idx_backward_launches"),
        "nee_backward (unpermute reads)": (nee_mod.nee, "idx_backward_launches"),
        "preview_shade": (preview_shade, "launches"),
    }


def sharded_rank(scene, origins, dirs, uniforms, target, render_sp, train_sp, train_samples):
    """What each rank of phase 9 runs, on the card, with its kernels' launch
    counts (every count set to 0 first): ``sharded_render`` of the
    sample-major batch on the mesh of each ``sp`` of ``render_sp``, the
    whole image assembled, then ``sharded_train_step`` on the mesh of each
    ``sp`` of ``train_sp`` against ``target`` on the first
    ``train_samples`` samples.  Each step is timed on the second of two
    calls, and one all-reduce of the rank's slice after the render.
    Returns {"rank", "render": {sp: image}, "render_ms", "all_reduce_ms",
    "train": {sp: (loss, grads)}, "train_ms", "launches"}."""
    import torch
    import torch.distributed as dist
    from octree_pathtracing_tpu_torch.ops.texture import Atlas
    from octree_pathtracing_tpu_torch.parallel import (assemble_image, global_ray_batch, make_mesh, sharded_render,
                                                       sharded_train_step)

    table = counter_table()
    for fn, attr in table.values():
        setattr(fn, attr, 0)
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    scene = scene.to(dev)
    out = {"rank": dist.get_rank(), "render": {}, "render_ms": {}, "all_reduce_ms": {}, "train": {},
           "train_ms": {}}
    for sp in render_sp:
        mesh = make_mesh(sp=sp)
        o, d, u = global_ray_batch(mesh, (origins, dirs, uniforms), dev)
        for _ in range(2):  # the first call warms up
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            local = sharded_render(mesh, scene, o, d, u)
            torch.cuda.synchronize(dev)
        out["render_ms"][sp] = (time.perf_counter() - t0) * 1e3
        out["render"][sp] = assemble_image(mesh, local).cpu().numpy()
        probe = torch.zeros_like(local)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if mesh.size > 1:
            dist.all_reduce(probe)
        torch.cuda.synchronize(dev)
        out["all_reduce_ms"][sp] = (time.perf_counter() - t0) * 1e3
    atlas = scene.atlas.data if isinstance(scene.atlas, Atlas) else scene.atlas
    params = {"atlas": atlas, "emittance": scene.materials.emittance}
    for sp in train_sp:
        mesh = make_mesh(sp=sp)
        o, d, u, tgt = global_ray_batch(mesh, tuple(x[:train_samples] for x in (origins, dirs, uniforms, target)),
                                        dev)
        for _ in range(2):  # the first call warms up
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            loss, grads = sharded_train_step(mesh, scene, params, o, d, u, tgt)
            torch.cuda.synchronize(dev)
        out["train_ms"][sp] = (time.perf_counter() - t0) * 1e3
        out["train"][sp] = (float(loss), {k: g.cpu().numpy() for k, g in grads.items()})
    out["launches"] = {name: getattr(fn, attr) for name, (fn, attr) in table.items()}
    return out


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


def gather_bound(table, idx, tables: int = 1):
    """P1's bound: the indices, and per table the output rows and the
    table's rows read once (the rows gathered, or the whole table when that
    is smaller)."""
    row, n_out = table.shape[1] * 4, idx.numel()
    return bound(n_out * idx.element_size() + tables * (n_out + min(table.shape[0], n_out)) * row, 0)


def compare_hits(k, r, label: str, k_rec=None, r_rec=None, exact: bool = False) -> float:
    """Fail unless a kernel's result ``k`` (and record) matches the twin's
    ``r`` on every lane; returns the largest absolute difference of t, uv,
    the voxel corner and the record's uu / vv.  ``exact``: every field, the
    record's and the quad surfaces' too, must be equal bit for bit."""
    mismatch = {f: int((getattr(k, f) != getattr(r, f)).sum()) for f in ("hit", "leaf_value", "face_id", "fetches")}
    if exact:
        for f in ("t", "uv", "voxel_pos", "voxel_size"):
            mismatch[f] = int((~((getattr(k, f) == getattr(r, f)) | (getattr(k, f).isnan() & getattr(r, f).isnan()))).sum())
        if (k.quad is None) != (r.quad is None):
            raise AssertionError(f"only one side returned quad surfaces on {label}")
        if k.quad is not None:
            for f in k.quad._fields:
                mismatch[f"quad_{f}"] = int((getattr(k.quad, f) != getattr(r.quad, f)).sum())
        if k_rec is not None:
            for f in k_rec._fields:
                if getattr(k_rec, f) is not None:
                    mismatch[f"record_{f}"] = int((getattr(k_rec, f) != getattr(r_rec, f)).sum())
    h = r.hit
    t_err = (k.t[h] - r.t[h]).abs()
    t_bad = int((t_err > 1e-4 * r.t[h].abs().clamp(min=1.0)).sum())
    uv_err = (k.uv[h] - r.uv[h]).abs()
    uv_bad = int((uv_err > 1e-4).any(dim=-1).sum())
    vpos_err = (k.voxel_pos[h] - r.voxel_pos[h]).abs()
    errs = [t_err, uv_err, vpos_err]
    if k_rec is not None:
        for f in ("count", "mats", "face"):
            if f in k_rec._fields:
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


def shade_bound(call, out, resid, grad: bool):
    """K4's forward bound on one call: its lanes' inputs and outputs, the
    uniform words each lane reads, the distinct texels and material rows it
    read (from the kernel's residual), against its arithmetic by what each
    lane did (the residual's lane code).  A lane that does not scatter (a
    miss, the last bounce) reads no uniform; one that does reads those of
    its lobe choice (metal, specular, diffuse, in turn), the Fresnel draw
    where it refracts, and the direction pair of a diffuse or a rough
    specular lobe.  The importance warp's draw and redraws are not counted
    (they depend on the sun's cap): the bound stays a lower one."""
    import torch

    from octree_pathtracing_tpu_torch.ops.shading import EPSILON, U_METAL, U_SPECULAR

    scene, st, u = call[0], call[1], call[2]
    lanes = int(st["throughput"].shape[0])
    per_lane = SHADE_IN_BYTES + SHADE_OUT_BYTES + (SHADE_RESID_BYTES if grad else 0)
    per_lane += (SHADE_QUAD_BYTES if scene.has_quad_models else 0) + (SHADE_PRIM_BYTES if call[4] is not None else 0)
    # K7's scan folded in (primitives and no K7 hit given): the tables once,
    # the scan's arithmetic on each live lane, and no K7 hit read
    scan = scene.prims is not None and call[4] is None
    if len(call) > 7 and call[7] is not None:  # a frame's last bounce: idx read, the radiance stored through it
        per_lane += 4
    texels, mats, code = resid.ints.unbind(-1)
    m, ml = scene.materials, mats.long()
    scat = out.state["active"]
    lobe = code >> 2
    metal, spec = m.metalness[ml], m.specular[ml]
    do_metal = (metal > EPSILON) & (u[:, U_METAL] < metal)
    asks_spec = ~do_metal & (spec > EPSILON)
    do_spec = asks_spec & (u[:, U_SPECULAR] < spec)
    asks_diff = ~do_metal & ~do_spec
    do_diff = lobe == 2
    do_refr = asks_diff & ~do_diff & ((m.ior[ml] - m.ior[st["cur_mat"].long()]).abs() >= EPSILON)
    rough_dir = (do_metal | (lobe == 0)) & (m.roughness[ml] > EPSILON)
    words = ((metal > EPSILON).int() + asks_spec.int() + asks_diff.int() + do_refr.int()
             + 2 * (do_diff | rough_dir).int())
    u_words = int(torch.where(scat, words, 0).sum())
    n_bytes = (lanes * per_lane + 4 * u_words + int(texels.unique().numel()) * 16
               + int(mats.unique().numel()) * SHADE_MAT_ROW_BYTES)
    miss, lobe = int((code & 1).sum()), code >> 2
    diffuse = int((lobe == 2).sum())
    specular = lanes - miss - diffuse
    importance = OPS_SHADE_IMPORTANCE if scene.sun_sampling.importance_sampling else 0
    n_ops = (lanes * OPS_SHADE_LANE + miss * OPS_SHADE_SKY + diffuse * (OPS_SHADE_DIFFUSE + importance)
             + specular * OPS_SHADE_SPECULAR)
    if scan:
        n_bytes += prim_table_bytes(scene.prims)
        n_ops += int(st["active"].sum()) * prim_scan_ops(scene.prims)
    return bound(n_bytes, n_ops) + (u_words,)


def shade_backward_bound(args, src=None, idx=None):
    """K4's backward bound on one call's arguments (those of
    ``ops/shade._backward_cuda``), by the pointers the call passes and the
    lanes that need them: every lane's residual words; the albedo and the
    incoming throughput where a throughput cotangent comes, else on the
    emitting lanes; each cotangent given; the diffuse weight of a diffuse
    lane and the sky colour of a miss; the throughput gradient out where
    it is wanted; the emittance of the emitting lanes' materials; and the
    atlas and emittance gradients, dense outputs, written once.  ``src``
    (the main path's call after a compaction): its 4 B a lane, and the
    radiance cotangent read on every lane and written back at ``src``;
    ``idx`` (a frame's last bounce): its 4 B a lane, the cotangent read
    through it."""
    albedo, throughput, resid, emittance, atlas_shape, g_tp, g_rad, g_alb, need = args
    lanes = int(resid.ints.shape[0])
    _, mats, code = resid.ints.unbind(-1)
    miss, emit_on, lobe = (code & 1) != 0, (code & 2) != 0, code >> 2
    n_emit, n_miss, n_diff = int(emit_on.sum()), int(miss.sum()), int((lobe == 2).sum())
    n_bytes = lanes * 12  # texel, material, lane code
    n_bytes += (lanes if g_tp is not None else n_emit if g_rad is not None else 0) * (16 + 12)
    if g_tp is not None:
        n_bytes += lanes * 12 + n_diff * 4
    if src is not None:
        n_bytes += lanes * 4
    if idx is not None:
        n_bytes += lanes * 4
    if g_rad is not None and src is not None:  # read on every lane, moved to its row
        n_bytes += lanes * 24 + (n_miss * 12 if need[0] else 0) + int(mats[emit_on].unique().numel()) * 4
    elif g_rad is not None:  # read where it reaches the throughput's gradient or the emission
        n_bytes += (int((miss | emit_on).sum()) if need[0] else n_emit) * 12 + (n_miss * 12 if need[0] else 0)
        n_bytes += int(mats[emit_on].unique().numel()) * 4
    if g_alb is not None:
        n_bytes += lanes * 16
    if need[0]:
        n_bytes += lanes * 12
    if need[2]:
        n_bytes += atlas_shape[0] * atlas_shape[1] * atlas_shape[2] * 16
    if need[3]:
        n_bytes += emittance.numel() * 4
    return bound(n_bytes, lanes * OPS_SHADE_BWD)


def prim_table_bytes(prims) -> int:
    """K7's tables: a sphere's 5 words, a quad's row."""
    return prims.n_spheres * 20 + (0 if prims.quads is None else prims.quads.count) * QUAD_ROW_BYTES


def prim_scan_ops(prims) -> int:
    """K7's arithmetic on one ray: every sphere and quad test."""
    return prims.n_spheres * OPS_PER_SPHERE + (0 if prims.quads is None else prims.quads.count) * OPS_PER_PRIM_QUAD


def prim_bound(prims, lanes: int):
    """K7's bound: each ray in and out once, the tables once, against the
    arithmetic of every sphere and quad test."""
    return bound(lanes * PRIM_RAY_BYTES + prim_table_bytes(prims), lanes * prim_scan_ops(prims))


def preview_bound(scene, res):
    """K10's bound on one call, the bytes this call's data needs
    (``PREVIEW_*_BYTES``) and each distinct texel the hits read, once
    (16 B); its arithmetic is far below the float32 rate."""
    from octree_pathtracing_tpu_torch.ops.shade import resolve_hit
    from octree_pathtracing_tpu_torch.ops.texture import texel_index

    lanes, hits = int(res.hit.shape[0]), int(res.hit.sum())
    mat, uv, _, _ = resolve_hit(scene, None, None, res)
    layer = scene.materials.texture_index[mat.long()]
    texels = texel_index(scene.atlas, layer, uv[:, 0], uv[:, 1])[res.hit].unique().numel()
    n_bytes = lanes * PREVIEW_PIXEL_BYTES + (lanes - hits) * PREVIEW_MISS_BYTES + hits * PREVIEW_HIT_BYTES
    if res.quad is not None:
        n_bytes += hits + int((res.quad.found & res.hit).sum()) * PREVIEW_QUAD_BYTES
    return bound(n_bytes + texels * 16, 0) + (texels,)


def nee_bounds(chk, idx: bool = False) -> dict:
    """The next-event kernels' bounds on one ``utils/timing.check_nee``
    result: {kernel: (bound_ms, bound_by)}.  Each counts its lanes' and
    faces' inputs and outputs (NEE_* above), the walk record entries and
    primitive hits its cast faces read, the distinct texels, supercell rows
    and emitter materials they name, and the dense gradients once, against
    its arithmetic by face and slot.  ``idx`` (a frame's last bounce, the
    unpermute folded in): ``nee_resolve`` reads 4 B more a lane, and
    ``nee_backward`` 4 B more and writes the radiance's 12."""
    import torch

    from octree_pathtracing_tpu_torch.ops import nee as k

    c = chk["args"]["setup"][0]
    scene, plan = c.scene, c.plan
    b = int(c.cur_mat.shape[0])
    fb = plan.faces * b
    rays, (walk, prim) = chk["rays"], chk["walk"]
    ints = chk["args"]["backward"][2].ints.reshape(fb, k.RESID_INTS)
    cast = rays.active
    n_cast = int(cast.sum())
    sun_rows = torch.zeros(fb, dtype=torch.bool, device=cast.device)
    if plan.sun:
        sun_rows[:b] = True
    n_cast_em = int((cast & ~sun_rows).sum())
    # nee_setup
    u_words, grid_bytes = 0, 0
    if plan.sun:
        sss = (scene.materials.flags[c.mat.long()] & 2) != 0
        u_words += 2 * b + int(sss.sum())
    em = scene.emitters
    if plan.emitters is not None:
        u_words += 3 * b
        grid_bytes = em.count * EMITTER_ROW_BYTES
        if plan.emitters == "one" and em.grid_idx is not None:
            g = 1 << em.grid_bits
            p = torch.where(c.diffuse_on[:, None], c.hitpoint, 0.0) + (0.01 * em.cell_size) * c.normal
            cell = torch.clamp((p / em.cell_size).to(torch.int32), 0, g - 1)
            rows = ((cell[:, 0] * g + cell[:, 1]) * g + cell[:, 2]).unique().numel()
            grid_bytes += int(rows) * em.grid_idx.shape[1] * 8
    # K7's scan folded in: the tables once, the scan of each cast ray, its
    # slots written on every row (a miss where not cast)
    scan = getattr(rays, "p_hit", None) is not None
    setup = bound(b * NEE_SETUP_LANE_BYTES + (4 * b if plan.sun else 0) + 4 * u_words + fb * NEE_RAY_BYTES
                  + grid_bytes + ((fb * NEE_PRIM_SLOT_BYTES + prim_table_bytes(scene.prims)) if scan else 0),
                  b * ((OPS_NEE_SUN if plan.sun else 0) + (OPS_NEE_PICK if plan.emitters == "one" else 0))
                  + (fb - (b if plan.sun else 0)) * OPS_NEE_FACE + (n_cast * prim_scan_ops(scene.prims) if scan else 0))
    # nee_resolve: the records its cast faces read
    slots = ints[:, 1:1 + k.N_SLOTS]
    used = slots >= 0
    if hasattr(walk, "mats"):
        reads = torch.clamp(walk.count[cast], max=k.K_SURFACES)
        rec = 4 * n_cast + 12 * int(used[:, :k.K_SURFACES].sum()) + (4 * int(reads.sum()) if walk.ts is not None else 0)
    else:
        rec = n_cast + 20 * int(walk.hit[cast].sum())
    if prim is not None:
        rec += n_cast + 16 * int(prim[0][cast].sum())
    em_cast = cast & ~sun_rows
    texels = torch.cat([slots[used], ints[em_cast, -2]]).unique().numel()
    e_mats = ints[em_cast, -1].unique().numel()
    n_slots = int(used.sum())
    lane_bytes = NEE_RESOLVE_LANE_BYTES + (4 if idx else 0)
    resolve = bound(b * lane_bytes + fb + 8 * n_cast + 8 * n_cast_em + rec + 16 * int(texels)
                    + 4 * int(e_mats), n_cast * OPS_NEE_RESOLVE_FACE + n_slots * OPS_NEE_SLOT)
    data = scene.atlas.data if hasattr(scene.atlas, "sizes") else scene.atlas
    bwd_lane_bytes = NEE_BWD_LANE_BYTES + (16 if idx else 0)
    backward = bound(b * bwd_lane_bytes + 4 * fb + NEE_RESID_BYTES * n_cast + 16 * int(texels)
                     + 4 * int(e_mats) + data.numel() * 4 + scene.materials.emittance.numel() * 4,
                     n_cast * OPS_NEE_BWD_FACE + n_slots * OPS_NEE_BWD_SLOT)
    return {"nee_setup": setup, "nee_resolve": resolve, "nee_backward": backward}


def main() -> int:
    # The port never needs jax or the JAX package; block both so that no
    # module reached from here loads them.
    t_start = time.perf_counter()
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
        analytic_sphere_scene,
        cutout_chunk_scene,
        face_normals,
        minecraft_chunk_scene,
        octree_from_grid,
        pixel_grid_rays,
        plant_scene,
    )
    from octree_pathtracing_tpu_torch.models import mca, minecraft_scene_from_region, native
    from octree_pathtracing_tpu_torch.models import prims as prims_mod
    from octree_pathtracing_tpu_torch.models.prims import intersect_prims, intersect_prims_reference
    from octree_pathtracing_tpu_torch.models.emitters import sample_emitter_point, with_emitter_sampling
    from octree_pathtracing_tpu_torch.models.sun import SunSampling, random_sun_direction
    from octree_pathtracing_tpu_torch.ops import bvh as bvh_mod
    from octree_pathtracing_tpu_torch.ops import shade as shade_mod
    from octree_pathtracing_tpu_torch.ops import nee as nee_mod
    from octree_pathtracing_tpu_torch.ops import compact as compact_mod
    from octree_pathtracing_tpu_torch.ops import preview as preview_mod
    from octree_pathtracing_tpu_torch.ops import gather
    from octree_pathtracing_tpu_torch.ops.bvh import (
        BVH,
        bvh_intersect_quads,
        bvh_intersect_reference,
        quad_prim_fn,
    )
    from octree_pathtracing_tpu_torch.ops import random as prandom
    from octree_pathtracing_tpu_torch.ops import traversal
    from octree_pathtracing_tpu_torch.ops.gather import (
        row_gather,
        row_gather_pair,
        row_gather_pair_reference,
        row_gather_reference,
    )
    from octree_pathtracing_tpu_torch.ops.random import philox_uniforms, philox_uniforms_reference
    from octree_pathtracing_tpu_torch.ops.geometry import make_quads
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
    from octree_pathtracing_tpu_torch.render.hit import accept_tables, resolve_hit
    from octree_pathtracing_tpu_torch.utils.timing import (
        argsort_route,
        both,
        bounce_rays,
        call_ms,
        capture_frame,
        card_line,
        check_compact,
        check_nee,
        check_shade,
        compact_calls,
        device_ms,
        fetch_stats,
        host_ms,
        nee_calls,
        nonzero_route,
        kernel_names,
        profile_launches,
        replay_ms,
        shade_calls,
        shade_gradients,
        tiled_compaction,
        unfolded,
    )

    counters = counter_table()
    # folded into the kernels that read their results: no main path launches them
    FOLDED = ("prims_intersect", "compact_backward", "unpermute", "unpermute_backward")
    PORT_KERNELS = kernel_names()  # the port's own kernels by name, found among a session's activities
    # the counters of launches already counted under another name (a fold's variant of a kernel)
    SUBSET_COUNTERS = ("shade (K7 scan)", "nee_setup (K7 scan)", "shade_backward (src stores)",
                       "nee_backward (src stores)", "shade (unpermute stores)", "nee_resolve (unpermute stores)",
                       "shade_backward (unpermute reads)", "nee_backward (unpermute reads)")
    # the twins' own entry points, counted so that a main path can show it ran none
    twin_calls = {"preview twin": 0, "traversal twin": 0, "K7 twin": 0, "K8 twin": 0, "K4 twin": 0,
                  "K4 backward twin": 0,
                  "nee_setup twin": 0, "nee_resolve twin": 0, "nee_backward twin": 0, "K5 twin": 0,
                  "K5 backward twin": 0, "unpermute twin": 0, "unpermute backward twin": 0}
    real_walk, real_prims_twin = traversal._walk_reference, prims_mod.intersect_prims_reference
    real_bvh_twin = bvh_mod.bvh_intersect_reference
    real_shade_twin, real_shade_bwd_twin = shade_mod.shade_reference, shade_mod.shade_backward_reference

    def counting_walk(*a, **kw):
        twin_calls["traversal twin"] += 1
        return real_walk(*a, **kw)

    def counting_prims_twin(*a, **kw):
        twin_calls["K7 twin"] += 1
        return real_prims_twin(*a, **kw)

    def counting_bvh_twin(*a, **kw):
        twin_calls["K8 twin"] += 1
        return real_bvh_twin(*a, **kw)

    def counting_shade_twin(*a, **kw):
        twin_calls["K4 twin"] += 1
        return real_shade_twin(*a, **kw)

    def counting_shade_bwd_twin(*a, **kw):
        twin_calls["K4 backward twin"] += 1
        return real_shade_bwd_twin(*a, **kw)

    def counting(name, fn):
        def counted(*a, **kw):
            twin_calls[name] += 1
            return fn(*a, **kw)

        return counted

    real_nee = {name: getattr(nee_mod, f"{name}_reference") for name in NEE_KERNELS}
    for name, fn in real_nee.items():
        setattr(nee_mod, f"{name}_reference", counting(f"{name} twin", fn))
    real_k5 = {f: getattr(compact_mod, f) for f in ("compact_reference", "compact_backward_reference",
                                                    "unpermute_reference", "unpermute_backward_reference")}
    for f, twin_name in zip(real_k5, ("K5 twin", "K5 backward twin", "unpermute twin", "unpermute backward twin")):
        setattr(compact_mod, f, counting(twin_name, real_k5[f]))
    traversal._walk_reference = counting_walk
    prims_mod.intersect_prims_reference = counting_prims_twin
    bvh_mod.bvh_intersect_reference = counting_bvh_twin
    shade_mod.shade_reference = counting_shade_twin
    shade_mod.shade_backward_reference = counting_shade_bwd_twin
    real_preview_twin = preview_mod.preview_shade_reference
    preview_mod.preview_shade_reference = counting("preview twin", real_preview_twin)

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        for name in twin_calls:
            twin_calls[name] = 0

    def twin_backward(*a, src=None, idx=None):
        """K4's backward twin; on a frame's last bounce the radiance
        cotangent read at ``idx``, and after a compaction each row's
        gradients moved to the row it came from, as the kernel does."""
        d = shade_mod.shade_backward_reference(*a, idx=idx)
        return d if src is None else (*compact_mod.store_at_src_reference(src, *d[:2]), *d[2:])

    @contextlib.contextmanager
    def k4_twins():
        """K4's kernels replaced by its twins, on the card: the eager shading
        that the main paths ran before K4 had kernels."""
        with mock.patch.object(shade_mod, "_forward_cuda", lambda call, want_grad: shade_mod.shade_reference(*call)), \
                mock.patch.object(shade_mod, "_backward_cuda", twin_backward):
            yield

    @contextlib.contextmanager
    def nee_plain():
        """K4's next-event half through its plain versions, differentiated by
        autograd (the eager path the light lines ran before its kernels)."""
        with mock.patch.object(pathtracer, "nee", lambda *a, **kw: nee_mod.nee_reference(*a, **kw)[0]):
            yield

    @contextlib.contextmanager
    def twins():
        """Every kernel's wrapper replaced by its twin where the paths call it."""
        with k4_twins(), nee_plain(), mock.patch.object(pathtracer, "traverse", traverse_reference), \
                mock.patch.object(pathtracer, "traverse_alpha", traverse_alpha_reference), \
                mock.patch.object(pathtracer, "traverse_shadow", traverse_shadow_reference), \
                mock.patch.object(pathtracer, "intersect_prims", intersect_prims_reference), \
                mock.patch.object(nee_mod, "traverse", traverse_reference), \
                mock.patch.object(nee_mod, "traverse_alpha", traverse_alpha_reference), \
                mock.patch.object(nee_mod, "traverse_shadow", traverse_shadow_reference), \
                mock.patch.object(nee_mod, "intersect_prims", intersect_prims_reference), \
                mock.patch.object(pathtracer, "compact_for_bounce", k5_plain):
            yield

    def k5_plain(st, uniforms, bounce, counts):
        """K5 through its plain version on the card, differentiated by
        autograd (its gathers) where a gradient is taken."""
        out, u_b, _ = real_k5["compact_reference"](st, uniforms, bounce, counts)
        return out, u_b

    def high_quality(sc, emitter_sampling="none"):
        """``sc`` under the HIGH_QUALITY sun and ``--emitter-sampling``."""
        return with_emitter_sampling(dataclasses.replace(sc, sun_sampling=SunSampling.high_quality()),
                                     emitter_sampling)
    main_path_launches = dict.fromkeys(counters, 0)

    def wrapper_kernels(fn) -> int:
        """The kernels the wrappers launch over one call of ``fn``: their
        counts' growth (each launch is one kernel)."""
        def total():
            return sum(getattr(f, a) for name, (f, a) in counters.items() if name not in SUBSET_COUNTERS)

        before = total()
        fn()
        return total() - before

    def counted_launches(fn, others: bool = False):
        """The device activities torch.profiler records over one call of
        ``fn`` (which synchronizes; the second of two calls in each session,
        ``utils/timing.profiled_names``), held against the wrappers' counts
        over one call: a session that shows another number of the port's own
        kernels than the wrappers launched dropped some, so sessions go on
        until one shows them all, and the fullest of those counts; where
        none does after 12, no count is given.  ``others``: with the names
        of the kernels that are not the port's (PyTorch's own)."""
        n = wrapper_kernels(fn)
        got = profile_launches(fn, ours=PORT_KERNELS, expect_ours=n)
        names = got.pop("others")
        if got.pop("ours") != n:
            return (f"not counted: none of {got['sessions']} profiler sessions showed the {n} kernels the wrappers "
                    f"launched")
        got["port_kernels"] = n
        if others:
            got["other_kernels"] = dict(Counter(x.split("(")[0][-60:] for x in names))
        return got

    def read_counts(path: str, required):
        counts = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
        for name, n in counts.items():
            main_path_launches[name] += n
        log(f"  launches on {path}: {counts}; twin calls {twin_calls}")
        missing = [name for name in required if counts[name] <= 0]
        if missing:
            raise AssertionError(f"{path} never launched {missing}")
        folded = [name for name in FOLDED if counts[name]]
        if folded:
            raise AssertionError(f"{path} launched {folded}, which the main paths run inside other kernels")
        if any(twin_calls.values()):
            raise AssertionError(f"{path} ran a twin on the card: {twin_calls}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} count {torch.cuda.device_count()}")
    out_dir = os.path.join(BUILD_DIR, "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)

    # host work started first, each in a process of its own: the survival
    # region's synthesis and the plant soup's BVH build (a minute on one core)
    import multiprocessing

    world_path = os.path.join(out_dir, "world", "r.0.0.mca")
    bvh_path = os.path.join(out_dir, f"plant_bvh_d{DEPTH}.npz")
    spawn = multiprocessing.get_context("spawn")
    for name, fn, fn_args in (("world", write_survival_region, (world_path, WORLD_SEED, WORLD_CHUNKS)),
                              ("bvh", build_plant_bvh, (bvh_path, DEPTH))):
        child = spawn.Process(target=_in_child, args=(fn, os.path.join(out_dir, f"{name}.json"), *fn_args))
        child.start()
        CHILDREN[name] = child

    def child_result(name: str) -> dict:
        child = CHILDREN[name]
        child.join()
        if child.exitcode != 0:
            raise RuntimeError(f"the {name} process failed (exit code {child.exitcode})")
        with open(os.path.join(out_dir, f"{name}.json")) as f:
            return json.load(f)

    # ---- 1. build the kernels from the checkout's sources, in parallel
    t0 = time.perf_counter()
    builds, errors = {}, []

    def build(name, loader):
        try:
            builds[name] = loader()
        except Exception as e:  # re-raised below, after both builds end
            errors.append(e)

    native_build = {}

    def build_native():  # host code: the region parser, g++ and zlib
        t = time.perf_counter()
        try:
            native.get_lib()
            native_build["result"] = f"built in {time.perf_counter() - t:.2f} s"
        except Exception as e:  # the numpy parser stands in, as in the JAX package
            native_build["result"] = f"not built ({type(e).__name__}: {e}); the numpy parser reads regions"

    threads = [threading.Thread(target=build, args=a)
               for a in (("traversal", traversal._library), ("uniforms", prandom._library),
                         ("gather", gather._library), ("prims", prims_mod._library), ("bvh", bvh_mod._library),
                         ("shade", shade_mod._library), ("nee", nee_mod._library),
                         ("compact", compact_mod._library), ("preview", preview_mod._library))]
    threads.append(threading.Thread(target=build_native))
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    log(f"phase 1 build: the nine libraries loaded in {time.perf_counter() - t0:.2f} s; the C++ region "
        f"parser {native_build['result']}")
    for name, lib in builds.items():
        info = lib.build_info
        log(f"  {name}: nvcc {info['seconds']:.2f} s -> {os.path.relpath(info['path'])}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line or "Compiling" in line:
                log(f"    ptxas: {line.strip()}")
    p2_grid = prandom._library().philox_resident_blocks()
    log(f"  P2's grid: {p2_grid} blocks of 256 threads (SMs x resident blocks)")
    k4_probe = minecraft_chunk_scene(depth=3)[0].to(dev)  # the terrain's tables: 6 materials, 6 atlas layers
    k4_scan_probe = analytic_sphere_scene(depth=3)[0].to(dev)  # a sphere and a quad: K4's variant with K7's scan
    for probe, what in ((k4_probe, "terrain"), (k4_scan_probe, "analytic")):
        for lanes in (WIDTH * HEIGHT, 4072):
            cfg = shade_mod.launch_configs(probe, lanes)
            for name, c in cfg.items():
                if what == "analytic" and name == "backward":
                    continue
                log(f"  K4 {name}{' (' + c['variant'] + ' variant)' if name == 'forward' else ''} on {lanes} {what} "
                    f"lanes: {c['blocks']} blocks of {c['threads']} threads, {c['smem_bytes']} bytes of shared "
                    f"memory per block, {c['resident_blocks_per_sm']} resident blocks per SM on {c['sms']} SMs, "
                    f"{c['registers']} registers, {c['stack_bytes']}-byte stack frame; "
                    + (f"tables read from {c['tables']}" if name == "forward" else f"sums {c['sums']}"))
    c = nee_mod.setup_attributes(dev)
    log(f"  nee_setup: {c['plain']['registers']} registers, {c['plain']['stack_bytes']}-byte stack frame; its "
        f"variant with K7's scan of each cast ray {c['scan']['registers']} registers, {c['scan']['stack_bytes']}-byte "
        f"stack frame")
    for lanes in (WIDTH * HEIGHT, 8 * 512 * 512):
        c = nee_mod.backward_config(lanes, tuple(k4_probe.atlas.shape), k4_probe.materials.emittance.numel(), dev)
        log(f"  nee_backward on {lanes} terrain lanes: a {c['launch']} launch of {c['blocks']} blocks of "
            f"{c['threads']} threads ({c['resident_blocks_per_sm']} resident blocks per SM on {c['sms']} SMs), "
            f"the lanes grid-stride, then a grid-wide barrier and the dense float32 gradients from the card's "
            f"float64 scratch")
    for lanes in (WIDTH * HEIGHT, 2097152):
        c = compact_mod.launch_config(lanes, dev)
        log(f"  compact_forward on {lanes} lanes: {c['blocks']} blocks of {c['threads']} threads, tiles of "
            f"{c['tile']} lanes taken by ticket for their live lanes, then by block index for their dead ones, "
            f"{c['smem_bytes']} bytes of shared memory per block, {c['resident_blocks_per_sm']} resident blocks "
            f"per SM on {c['sms']} SMs, {c['registers']} registers")
    c = nee_mod.resolve_config(WIDTH * HEIGHT, dev)
    log(f"  nee_resolve on {WIDTH * HEIGHT} lanes: {c['blocks']} blocks of {c['threads']} threads, a face's reads "
        f"issued before its fold, {c['registers']} registers, {c['resident_blocks_per_sm']} resident blocks per SM")
    log(f"  the traversal's stack: {(DEPTH + 1) * 8} bytes of dynamic shared memory per thread at depth {DEPTH} "
        f"(depth + 1 rows of parent and t_max), beside the registers and stack frame ptxas reports")

    results = {name: {} for name in KERNELS}

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
    err_k1 = compare_hits(traverse(*args), traverse_reference(*args), "K1, random depth-4 octree, 4096 rays", exact=True)

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
    err_k1 = max(err_k1, compare_hits(k_res, traverse_reference(*prim), f"K1, depth-{DEPTH} terrain, {WIDTH}x{HEIGHT} primaries",
                                      exact=True))
    bound_ms, bound_by, fetches = traversal_bound(k_res)
    results["esvo_traverse"] = dict(
        max_abs_err=err_k1, ms=call_ms(lambda: traverse(*prim), 50),
        device_ms=device_ms(lambda: traverse(*prim))[0],
        plain_ms=call_ms(lambda: traverse_reference(*prim), 3), bound_ms=bound_ms, bound_by=bound_by,
        **fetch_stats(k_res.fetches))
    log(f"  K1 {results['esvo_traverse']['ms']!r} ms (device {results['esvo_traverse']['device_ms']!r} ms), twin {results['esvo_traverse']['plain_ms']!r} ms, "
        f"bound {bound_ms!r} ms ({bound_by}: {fetches} node rows fetched; per ray {fetch_stats(k_res.fetches)}) "
        f"on the {WIDTH}x{HEIGHT} depth-{DEPTH} primaries [{card}]")
    # K1 on bounces 2-5 of one headline frame (phase 5's uniforms): the
    # whole batch, K5's live lanes first, with its active mask
    bounces = {}
    frame_u = pathtracer.draw_uniforms(1, 0, WIDTH * HEIGHT, N_BOUNCES, dev)
    for k, (bo, bd, b_act) in enumerate(bounce_rays(pathtracer, scene, prim[4], prim[5], frame_u)[1:], start=2):
        brays = prim[:4] + (bo, bd, 1024.0, b_act)
        b_live = int(b_act.sum())
        b_res = traverse(*brays)
        err_k1 = max(err_k1, compare_hits(b_res, traverse_reference(*brays),
                                          f"K1, headline bounce {k}, {bo.shape[0]} lanes, {b_live} live", exact=True))
        bt = both(lambda r=brays: traverse(*r))
        b_bound = traversal_bound(b_res)
        bounces[f"bounce {k}"] = dict(lanes=int(bo.shape[0]), live=b_live, ms=bt["call_ms"], device_ms=bt["device_ms"],
                                      bound_ms=b_bound[0], **fetch_stats(b_res.fetches))
        log(f"  K1 call {bt['call_ms']!r} ms, device {bt['device_ms']!r} ms ({bt['device_by']}), bound {b_bound[0]!r} ms "
            f"({b_bound[2]} node rows; per ray {fetch_stats(b_res.fetches)}) on the {bo.shape[0]} lanes ({b_live} "
            f"live) of headline bounce {k} [{card}]")
    results["esvo_traverse"]["headline_bounces"] = bounces

    # K4 forward and backward on the headline's lanes: bounce 1's 65,536,
    # then bounces 2-5's (the whole batch, K5's live lanes first; phase 5's
    # uniforms); the backward
    # with the cotangents that a real fwd+bwd of the same frame hands each
    # bounce (bench.py's mean-radiance loss, the atlas and the emittance
    # taking gradient)
    def unpermute_row(call, k_out, k_res, bwd_args, cot, src_k, f_err, f_t, f_bound):
        """The headline's last bounce as the main path shades it: K4 given
        the compaction's idx stores its radiance in the lanes' order, and its
        backward reads the cotangent there (through src too), each bit-equal
        to K4 storing in row order, then the standalone unpermute (and the
        unpermute's gather, then the backward); timed beside that route."""
        idx_k = call[7]
        rows_call = call[:7]
        k_rows = shade_mod._forward_cuda(rows_call, False)[0]
        unp = compact_mod._unpermute_cuda(k_rows.state["radiance"], idx_k, True)
        if not torch.equal(k_out.state["radiance"].view(torch.int32), unp.view(torch.int32)):
            raise AssertionError("K4 storing the last bounce's radiance at idx disagrees with K4 + unpermute")
        g_lane = cot[1]
        gathered = compact_mod._unpermute_cuda(g_lane, idx_k, False)
        rows_args = list(bwd_args)
        rows_args[6] = gathered
        d_fold = shade_mod._backward_cuda(*bwd_args, src=src_k, idx=idx_k)
        d_rows = shade_mod._backward_cuda(*rows_args, src=src_k)
        if not all((a is None and b is None) or (a is not None and b is not None and torch.equal(
                a.view(torch.int32), b.view(torch.int32))) for a, b in zip(d_fold[:2], d_rows[:2])):
            raise AssertionError("K4's backward reading the cotangent at idx disagrees with the unpermute's gather "
                                 "then K4's backward")
        rows_t = both(lambda: shade_mod.shade(*rows_call))
        unp_t = both(lambda: compact_mod._unpermute_cuda(k_rows.state["radiance"], idx_k, True))
        b_t = both(lambda: shade_mod._backward_cuda(*bwd_args, src=src_k, idx=idx_k))
        b_rows = both(lambda: shade_mod._backward_cuda(*rows_args, src=src_k))
        gat_t = both(lambda: compact_mod._unpermute_cuda(g_lane, idx_k, False))
        b_bound = shade_backward_bound(bwd_args, src_k, idx_k)
        lanes = int(idx_k.shape[0])
        results["shade (unpermute stores)"] = row = dict(
            lanes=lanes, max_abs_err=f_err, ms=f_t["call_ms"], device_ms=f_t["device_ms"],
            plain_ms=call_ms(lambda: real_shade_twin(*call), 5), bound_ms=f_bound[0], bound_by=f_bound[1],
            library_ms=None, unfolded_ms=rows_t["call_ms"] + unp_t["call_ms"],
            unfolded_device_ms=rows_t["device_ms"] + unp_t["device_ms"], row_order_device_ms=rows_t["device_ms"],
            unpermute_device_ms=unp_t["device_ms"], backward_ms=b_t["call_ms"], backward_device_ms=b_t["device_ms"],
            backward_bound_ms=b_bound[0], backward_bound_by=b_bound[1],
            unfolded_backward_device_ms=gat_t["device_ms"] + b_rows["device_ms"])
        log(f"  K4 on the headline's last bounce storing its radiance at idx (the unpermute folded in), bit-equal to "
            f"K4 in row order + unpermute_kernel, forward and backward: call {row['ms']!r} ms, device "
            f"{row['device_ms']!r} ms, bound {row['bound_ms']!r} ms ({row['bound_by']}); the route before: K4 "
            f"{row['row_order_device_ms']!r} + unpermute {row['unpermute_device_ms']!r} ms on the device; its "
            f"backward through src and idx {row['backward_device_ms']!r} ms (bound {row['backward_bound_ms']!r}), "
            f"before: gather {gat_t['device_ms']!r} + backward through src {b_rows['device_ms']!r} ms [{card}]")

    k4_rows = {"shade": {}, "shade_backward": {}}
    k4_grads = shade_gradients(pathtracer, scene, prim[4], prim[5], frame_u)
    k4_calls = shade_calls(pathtracer, scene, prim[4], prim[5], frame_u)
    if len(k4_grads) != len(k4_calls):
        raise AssertionError(f"K4: {len(k4_calls)} forward calls but {len(k4_grads)} backward calls in one frame")
    for k, (rec, grad_args) in enumerate(zip(k4_calls, k4_grads), start=1):
        sc_k, st_k, u_k, res_k, is_first, may_scatter = rec[:6]
        idx_k = rec[6] if len(rec) > 6 else None  # the last bounce: the final unpermute folded into K4's stores
        call = (sc_k, st_k, u_k, res_k, None, is_first, may_scatter, idx_k)
        lanes, live_k = int(st_k["throughput"].shape[0]), int(st_k["active"].sum())
        cot, need = grad_args[5:8], grad_args[8]
        chk = check_shade(call, cot, need, f"headline bounce {k}")
        k_out, k_res, bwd_args = chk["out"], chk["resid"], chk["backward_args"]
        if not torch.equal(grad_args[2].ints, k_res.ints):  # the cotangents belong to these lanes
            raise AssertionError(f"K4: the fwd+bwd's bounce {k} shaded other lanes than the forward's")
        log(f"  K4 headline bounce {k}: {lanes} lanes, {live_k} live; lanes not bit-equal per field {chk['differ']}; outside "
            f"rtol 1e-5 / atol 1e-6: {chk['outside']}; forward max abs err {chk['forward_err']!r}; backward "
            f"cotangents {[g is not None for g in cot]} (throughput, radiance, albedo), gradients wanted "
            f"{list(need)}, max abs err {chk['backward_err']!r}")
        f_t = both(lambda: shade_mod.shade(*call))
        f_bound = shade_bound(call, k_out, k_res, grad=False)
        if idx_k is not None:
            unpermute_row(call, k_out, k_res, bwd_args, cot, grad_args[9], chk["forward_err"], f_t, f_bound)
        b_t = both(lambda: shade_mod._backward_cuda(*bwd_args))
        b_bound = shade_backward_bound(bwd_args)
        # the main path's backward after a compaction stores through its src
        src_k = grad_args[9] if len(grad_args) > 9 else None
        b_src = None
        if src_k is not None:
            d_direct = shade_mod._backward_cuda(*bwd_args)
            d_src = shade_mod._backward_cuda(*bwd_args, src=src_k)
            moved = src_k.long()
            if not (torch.equal(d_src[0][moved], d_direct[0])
                    and (cot[1] is None or torch.equal(d_src[1][moved], cot[1]))):
                raise AssertionError(f"K4's backward through src disagrees with its stores in place on bounce {k}")
            b_src = dict(both(lambda: shade_mod._backward_cuda(*bwd_args, src=src_k)),
                         bound=shade_backward_bound(bwd_args, src_k))
        cfg = shade_mod.launch_configs(sc_k, lanes)
        variants = {"shade": f"tables read from {cfg['forward']['tables']}, {cfg['forward']['blocks']} blocks of "
                             f"{cfg['forward']['threads']}",
                    "shade_backward": f"{cfg['backward']['sums']} sums, {cfg['backward']['blocks']} blocks of "
                                      f"{cfg['backward']['threads']}"}
        rows = {"shade": dict(lanes=lanes, live=live_k, max_abs_err=chk["forward_err"], ms=f_t["call_ms"],
                              device_ms=f_t["device_ms"], plain_ms=call_ms(lambda: real_shade_twin(*call), 5),
                              bound_ms=f_bound[0], bound_by=f_bound[1], uniform_words=f_bound[2],
                              variant=variants["shade"]),
                "shade_backward": dict(lanes=lanes, live=live_k, max_abs_err=chk["backward_err"], ms=b_t["call_ms"],
                                       device_ms=b_t["device_ms"],
                                       plain_ms=call_ms(lambda: real_shade_bwd_twin(*bwd_args), 5),
                                       bound_ms=b_bound[0], bound_by=b_bound[1],
                                       cotangents=[g is not None for g in cot], variant=variants["shade_backward"],
                                       **({} if b_src is None else dict(src_ms=b_src["call_ms"],
                                                                        src_device_ms=b_src["device_ms"],
                                                                        src_bound_ms=b_src["bound"][0],
                                                                        src_bound_by=b_src["bound"][1])))}
        for name, row in rows.items():
            k4_rows[name][f"bounce {k}"] = row
            log(f"  {name} call {row['ms']!r} ms, device {row['device_ms']!r} ms "
                f"({(f_t if name == 'shade' else b_t)['device_by']}), twin {row['plain_ms']!r} ms, bound "
                f"{row['bound_ms']!r} ms ({row['bound_by']}) on the {lanes} lanes of headline bounce {k}; "
                f"variant: {row['variant']}"
                + (f"; storing through the compaction's src (the main path's call): call {row['src_ms']!r} ms, "
                   f"device {row['src_device_ms']!r} ms, bound {row['src_bound_ms']!r} ms ({row['src_bound_by']})"
                   if "src_ms" in row else "") + f" [{card}]")
    for name, rows in k4_rows.items():  # the row of bounce 1 (the 256^2 primaries), the others beside it
        results[name] = dict(rows["bounce 1"], max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                             headline_bounces={b: r for b, r in rows.items() if b != "bounce 1"})

    # K5 on the compactions of one headline frame (bounces 2-5, phase 5's
    # uniforms), on its bounce-2 state repeated to 1,048,576 and 2,097,152
    # lanes, on a branched frame's B x K lanes, on 1 lane and on a batch with
    # no live lane: bit for bit against the plain versions, forward and
    # backward; timed by call and on the device beside its byte bound, the
    # plain version and two library routes (a stable argsort with one
    # index_select per field; nonzero, gathers and index_puts, the main
    # path's route before the kernel)
    def recorded_compactions(fn):
        calls, real = [], pathtracer.compact_for_bounce

        def rec(st, uu, bounce, counts):
            calls.append(({k: v.detach().clone() for k, v in st.items()}, uu, bounce,
                          None if counts is None else counts.clone()))
            return real(st, uu, bounce, counts)

        with mock.patch.object(pathtracer, "compact_for_bounce", rec), torch.no_grad():
            fn()
        return calls

    k5_calls = compact_calls(pathtracer, scene, prim[4], prim[5], frame_u)
    bro, brd = pixel_grid_rays(cam, 64, 64)
    bu = torch.from_numpy(np.random.default_rng(3).random((64 * 64, 10, N_BOUNCES, 21), dtype=np.float32)).to(dev)
    k5_first = k5_calls[0]
    k5_cases = [(f"headline bounce {c[2] + 1}", c) for c in k5_calls] + [
        ("1,048,576 lanes", tiled_compaction(k5_first, 16)), ("2,097,152 lanes", tiled_compaction(k5_first, 32)),
        ("branched 64x64 x 10 lanes", recorded_compactions(lambda: pathtracer.trace_paths_branched(scene, bro, brd,
                                                                                                   bu))[0]),
        ("1 lane", ({k: None if v is None else v[:1] for k, v in k5_first[0].items()}, k5_first[1][:1],
                    k5_first[2], k5_first[3])),
        ("no live lane", (dict(k5_first[0], active=torch.zeros_like(k5_first[0]["active"])),) + k5_first[1:])]
    k5_rows = {name: {} for name in K5_KERNELS}
    for label, (st_c, u_c, bounce_c, counts_c) in k5_cases:
        chk = check_compact(st_c, u_c, bounce_c, label)
        lanes, live_c = chk["lanes"], chk["live"]
        log(f"  K5 {label}: {lanes} lanes, {live_c} live; forward, backward and unpermute bit-equal to their plain "
            f"versions")
        if not (label.startswith("headline") or label.startswith("2,097,152")):
            continue
        pos_c, g_tp, g_rad = chk["backward_args"]
        big = lanes > 1 << 20
        fns = {"compact_forward": (lambda: compact_mod._forward_cuda(st_c, u_c, bounce_c, counts_c),
                                   lambda: real_k5["compact_reference"](st_c, u_c, bounce_c),
                                   lambda: argsort_route(st_c, u_c, bounce_c), bound(lanes * K5_LANE_BYTES + 4, 0)),
               "compact_backward": (lambda: compact_mod._backward_cuda(pos_c, g_tp, g_rad),
                                    lambda: real_k5["compact_backward_reference"](pos_c, g_tp, g_rad), None,
                                    bound(lanes * (4 + 4 * 12), 0))}
        k5_cfg = compact_mod.launch_config(lanes, dev)
        k5_variant = {"compact_forward": f"tiles of {k5_cfg['tile']} lanes, {k5_cfg['threads']} threads, "
                                         f"{k5_cfg['blocks']} blocks, {k5_cfg['smem_bytes']} B of shared memory, "
                                         f"{k5_cfg['resident_blocks_per_sm']} resident per SM, {k5_cfg['registers']} "
                                         f"registers; one look-back over the live lanes, then the dead lanes "
                                         f"in a streaming pass, rows through registers, the uniforms word by word",
                      "compact_backward": "one thread a lane, grid-stride"}
        for name, (kernel, plain, library, (b_ms, b_by)) in fns.items():
            dms = device_ms(kernel, calls=10 if big else 100)[0]
            row = dict(lanes=lanes, live=live_c, max_abs_err=0.0, ms=call_ms(kernel, 20 if big else 200),
                       device_ms=dms, plain_ms=call_ms(plain, 5), bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       variant=k5_variant[name])
            if library is not None:
                lib_t = both(library)
                par_t = both(lambda: nonzero_route(st_c, u_c, bounce_c))
                row.update(library_ms=lib_t["call_ms"], library_device_ms=lib_t["device_ms"],
                           library_route="torch.argsort(~active, stable=True) + index_select per field",
                           parent_route_ms=par_t["call_ms"], parent_route_device_ms=par_t["device_ms"],
                           parent_route_device_by=par_t["device_by"])
            k5_rows[name][label] = row
            log(f"  {name} call {row['ms']!r} ms, device {dms!r} ms, plain {row['plain_ms']!r} ms, bound {b_ms!r} ms "
                f"({b_by}) on {label} ({lanes} lanes, {live_c} live); variant: {row['variant']}"
                + (f"; argsort + index_select call {row['library_ms']!r} ms, device {row['library_device_ms']!r} ms; "
                   f"nonzero + gathers + index_put (the route before the kernel) call {row['parent_route_ms']!r} ms, "
                   f"device {row['parent_route_device_ms']!r} ms ({row['parent_route_device_by']})"
                   if library is not None else "") + f" [{card}]")
        if label == "headline bounce 5":  # the frame's last state: the unpermute both ways
            rad_c, idx_c, g_c = chk["unpermute_args"]
            for name, scatter, x, plain, library in (
                    ("unpermute", True, rad_c, lambda: real_k5["unpermute_reference"](rad_c, idx_c),
                     lambda: torch.empty_like(rad_c).index_copy_(0, idx_c.long(), rad_c)),
                    ("unpermute_backward", False, g_c, lambda: real_k5["unpermute_backward_reference"](g_c, idx_c),
                     lambda: g_c.index_select(0, idx_c.long()))):
                t = both(lambda scatter=scatter, x=x: compact_mod._unpermute_cuda(x, idx_c, scatter))
                lib_t = both(library)
                b_ms, b_by = bound(lanes * (4 + 12 + 12), 0)
                k5_rows[name][label] = row = dict(
                    lanes=lanes, max_abs_err=0.0, ms=t["call_ms"], device_ms=t["device_ms"], plain_ms=call_ms(plain, 20),
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_t["call_ms"], library_device_ms=lib_t["device_ms"],
                    library_route="index_copy_" if scatter else "index_select")
                log(f"  {name} call {row['ms']!r} ms, device {row['device_ms']!r} ms, plain {row['plain_ms']!r} ms, "
                    f"bound {b_ms!r} ms ({b_by}), {row['library_route']} call {row['library_ms']!r} ms, device "
                    f"{row['library_device_ms']!r} ms on the headline's {lanes} lanes [{card}]")
    for name, rows in k5_rows.items():  # bounce 2's row (the unpermute's: the last state's), the others beside it
        head = rows.get("headline bounce 2", rows.get("headline bounce 5"))
        results[name] = dict(head, others={k: r for k, r in rows.items() if r is not head})
    del k5_calls, k5_cases, k5_first, bu

    # K4's next-event half on the bounce-1 lanes of the light lines, with the
    # radiance cotangent a real fwd+bwd of the frame hands them (bench.py's
    # mean-radiance loss, the atlas and the emittance taking gradient)
    nee_rows = {name: {} for name in NEE_KERNELS}

    def nee_phase2(line, sc, camera, uniforms):
        lo, ld = pixel_grid_rays(camera, WIDTH, HEIGHT)
        call = nee_calls(pathtracer, sc, lo, ld, uniforms)[0]
        chk = check_nee(call[:4], call[4], f"the {line} line's bounce 1")
        bounds = nee_bounds(chk)
        args = chk["args"]
        c = args["setup"][0]
        lanes, cast = int(c.cur_mat.shape[0]), int(chk["rays"].active.sum())
        scan = getattr(chk["rays"], "p_hit", None) is not None

        def plain_setup():  # with K7's plain version over the rays where nee_setup scans them
            rays = real_nee["nee_setup"](c.scene, c.plan, *c[2:])
            return (rays, real_prims_twin(sc.prims, rays.origin, rays.dir, 1024.0)) if scan else rays

        fns = {"nee_setup": (lambda: nee_mod._setup_cuda(c), plain_setup),
               "nee_resolve": (lambda: nee_mod._resolve_cuda(*args["resolve"]),
                               lambda: real_nee["nee_resolve"](c.scene, c.plan, *args["resolve"][1:4],
                                                               args["resolve"][6], args["resolve"][4],
                                                               args["resolve"][5], c.cur_mat, False)),
               "nee_backward": (lambda: nee_mod._backward_cuda(*args["backward"]),
                                lambda: real_nee["nee_backward"](*args["backward"]))}
        errs = {"nee_setup": chk["setup"]["max_abs_err"], "nee_resolve": chk["resolve"]["max_abs_err"],
                "nee_backward": chk["backward_err"]}
        extra = {}
        if scan:  # K7's slots against K7's plain version on every cast row (K7's own gate)
            rays = chk["rays"]
            on = rays.active
            want = real_prims_twin(sc.prims, rays.origin, rays.dir, 1024.0)
            unequal = {f: int((a[on] != w[on]).sum()) for f, a, w in zip(("hit", "t", "mat"), rays.prim[:3], want[:3])}
            hit = on & want[0]
            uv_err = float((rays.p_uv[hit] - want[3][hit]).abs().max()) if bool(hit.any()) else 0.0
            log(f"  nee_setup's primitive slots on the {line} line's {int(on.sum())} cast rows: {int(hit.sum())} hits; "
                f"against K7's plain version not bit-equal {unequal}, uv max abs diff {uv_err!r}; bit-equal to the "
                f"standalone K7 on {chk['setup']['prim_rows']} rows")
            if any(unequal.values()) or not uv_err <= 1e-6:
                raise AssertionError(f"nee_setup's primitive slots disagree with K7's plain version on the {line} line")
            errs["nee_setup"] = max(errs["nee_setup"], uv_err)
            entry = nee_mod._scene_entry(c.scene, c.plan)._replace(prims=False)

            def setup_then_k7():  # the route before the fold: nee_setup without the scan, K7 over its rays
                rays = nee_mod._setup_cuda(c, entry)
                return intersect_prims(sc.prims, rays.origin, rays.dir, 1024.0)

            t = both(setup_then_k7)
            extra = dict(unfolded_ms=t["call_ms"], unfolded_device_ms=t["device_ms"])
        gates = {"nee_setup": chk["setup"], "nee_resolve": chk["resolve"], "nee_backward": None}
        log(f"  next-event kernels, the {line} line's bounce 1: {lanes} lanes x {c.plan.faces} faces, {cast} cast; "
            f"rows not bit-equal: setup {chk['setup']['differ']}, resolve {chk['resolve']['differ']}, residual "
            f"{chk['resolve']['residual']['differ']}; backward max abs err {chk['backward_err']!r}")
        for name, (kernel, plain) in fns.items():
            t = both(kernel)
            if name == "nee_backward":  # the kernel leaves its float64 sums zero, eager and replayed
                torch.cuda.synchronize()
                if not all(bool((x == 0).all()) for x in nee_mod._SCRATCH[dev.index]):
                    raise AssertionError(f"nee_backward left its scratch nonzero on the {line} line")
            row = dict(lanes=lanes, faces=c.plan.faces, cast=cast, max_abs_err=errs[name], ms=t["call_ms"],
                       device_ms=t["device_ms"], plain_ms=call_ms(plain, 5), bound_ms=bounds[name][0],
                       bound_by=bounds[name][1], library_ms=None, **(extra if name == "nee_setup" else {}))
            if name == "nee_resolve":
                rc = nee_mod.resolve_config(lanes, dev)
                row["variant"] = (f"{rc['blocks']} blocks of {rc['threads']} threads, a face's reads before its fold, "
                                  f"{rc['registers']} registers, {rc['resident_blocks_per_sm']} resident per SM")
            if gates[name] is not None:
                row["not_bit_equal"] = gates[name]["not_bit_equal"]
            nee_rows[name][line] = row
            log(f"  {name} call {row['ms']!r} ms, device {row['device_ms']!r} ms ({t['device_by']}), plain "
                f"{row['plain_ms']!r} ms, bound {row['bound_ms']!r} ms ({row['bound_by']}) on the {line} line's "
                f"bounce-1 lanes" + (f"; variant: {row['variant']}" if "variant" in row else "")
                + (f"; nee_setup without the scan + K7 over its rays: call {row['unfolded_ms']!r} ms, device "
                   f"{row['unfolded_device_ms']!r} ms" if "unfolded_ms" in row else "") + f" [{card}]")

    def nee_results():
        """The next-event kernels' rows: the NEE line's, the other lines beside it."""
        for name, rows in nee_rows.items():
            results[name] = dict(rows["nee"], max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                                 lines={line: r for line, r in rows.items() if line != "nee"})

    for line, which, sampling in NEE_ROW_LINES:
        sc, camera = (scene, cam) if which == "terrain" else (cut, cut_cam)
        nee_phase2(line, high_quality(sc, sampling), camera, frame_u)
    nee_results()

    # nee_resolve on the NEE line's last bounce as the main path calls it:
    # given the compaction's idx it stores the frame's final radiance in the
    # lanes' order, and nee_backward reads the cotangent there; each
    # bit-equal to the same kernel in row order with the standalone
    # unpermute (its gather), and timed beside that route
    lo, ld = pixel_grid_rays(cam, WIDTH, HEIGHT)
    *_, (sc5, st5, u5, res5, first5, scatter5, idx5) = shade_calls(pathtracer, high_quality(scene), lo, ld, frame_u)
    out5 = shade_mod.shade(sc5, st5, u5, res5, None, first5, scatter5)  # K4 stores in row order on a light line
    chk = check_nee((sc5, st5, u5, out5), None, "the NEE line's last bounce")
    c5 = chk["args"]["resolve"][0]
    r_args = chk["args"]["resolve"][1:]
    fold_rad = nee_mod._resolve_cuda(c5, *r_args, None, idx5)[0]
    rows_rad = nee_mod._resolve_cuda(c5, *r_args)[0]
    if not torch.equal(fold_rad.view(torch.int32),
                       compact_mod._unpermute_cuda(rows_rad, idx5, True).view(torch.int32)):
        raise AssertionError("nee_resolve storing the last bounce's radiance at idx disagrees with nee_resolve + "
                             "unpermute")
    rays5, walk5, prim5, tp5, rad5, alb5 = r_args[:6]

    def plain_fold():
        return real_nee["nee_resolve"](c5.scene, c5.plan, rays5, walk5, prim5, alb5, tp5, rad5, c5.cur_mat, False,
                                       idx5)[0]

    fold_err = float((fold_rad - plain_fold()).abs().max())
    b_args = list(chk["args"]["backward"])
    g5 = b_args[7]
    rows_b = list(b_args)
    rows_b[7] = compact_mod._unpermute_cuda(g5, idx5, False)
    d_fold = nee_mod._backward_cuda(*b_args, idx=idx5)
    d_rows = nee_mod._backward_cuda(*rows_b)
    if not all((a is None and b is None) or (a is not None and b is not None and torch.equal(
            a.view(torch.int32), b.view(torch.int32))) for a, b in zip(d_fold, d_rows)):
        raise AssertionError("nee_backward reading the cotangent at idx disagrees with the unpermute's gather then "
                             "nee_backward")
    bounds5 = nee_bounds(chk, idx=True)
    f_t = both(lambda: nee_mod._resolve_cuda(c5, *r_args, None, idx5))
    rows_t = both(lambda: nee_mod._resolve_cuda(c5, *r_args))
    unp_t = both(lambda: compact_mod._unpermute_cuda(rows_rad, idx5, True))
    b_t = both(lambda: nee_mod._backward_cuda(*b_args, idx=idx5))
    b_rows = both(lambda: nee_mod._backward_cuda(*rows_b))
    gat_t = both(lambda: compact_mod._unpermute_cuda(g5, idx5, False))
    results["nee_resolve (unpermute stores)"] = row = dict(
        lanes=int(idx5.shape[0]), max_abs_err=fold_err, ms=f_t["call_ms"], device_ms=f_t["device_ms"],
        plain_ms=call_ms(plain_fold, 5), bound_ms=bounds5["nee_resolve"][0], bound_by=bounds5["nee_resolve"][1],
        library_ms=None, unfolded_ms=rows_t["call_ms"] + unp_t["call_ms"],
        unfolded_device_ms=rows_t["device_ms"] + unp_t["device_ms"], row_order_device_ms=rows_t["device_ms"],
        unpermute_device_ms=unp_t["device_ms"], backward_ms=b_t["call_ms"], backward_device_ms=b_t["device_ms"],
        backward_bound_ms=bounds5["nee_backward"][0], backward_bound_by=bounds5["nee_backward"][1],
        unfolded_backward_device_ms=gat_t["device_ms"] + b_rows["device_ms"])
    log(f"  nee_resolve on the NEE line's last bounce storing its radiance at idx (the unpermute folded in), "
        f"bit-equal to nee_resolve in row order + unpermute_kernel, forward and backward; against its plain version "
        f"max abs err {fold_err!r}: call {row['ms']!r} ms, device {row['device_ms']!r} ms, bound {row['bound_ms']!r} "
        f"ms ({row['bound_by']}); the route before: nee_resolve {row['row_order_device_ms']!r} + unpermute "
        f"{row['unpermute_device_ms']!r} ms on the device; nee_backward reading the cotangent at idx "
        f"{row['backward_device_ms']!r} ms (bound {row['backward_bound_ms']!r}), before: gather "
        f"{gat_t['device_ms']!r} + nee_backward {b_rows['device_ms']!r} ms [{card}]")
    del frame_u, chk, d_fold, d_rows, out5, st5, res5

    # P2 on the bench's uniform block and on ragged sizes, bit for bit: one
    # not a multiple of the grid's stride (2 blocks of 4 outputs per thread)
    n_block = WIDTH * HEIGHT * N_BOUNCES * 21
    err_p2 = 0.0
    for n in (n_block, n_block - 3, 1001, 7, 3 * p2_grid * 256 * 8 + 4099):
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
    p2 = both(lambda: philox_uniforms(12345, 7, n_block, dev))
    rand = both(lambda: torch.rand((WIDTH * HEIGHT, N_BOUNCES, 21), device=dev))
    results["philox_uniforms"] = dict(
        max_abs_err=err_p2, ms=p2["call_ms"], device_ms=p2["device_ms"],
        plain_ms=call_ms(lambda: philox_uniforms_reference(12345, 7, n_block, dev), 10),
        bound_ms=p2_bound[0], bound_by=p2_bound[1],
        library_ms=rand["call_ms"], library_device_ms=rand["device_ms"])
    log(f"  P2 call {p2['call_ms']!r} ms, device {p2['device_ms']!r} ms ({p2['device_by']}); torch.rand call "
        f"{rand['call_ms']!r} ms, device {rand['device_ms']!r} ms ({rand['device_by']}); twin "
        f"{results['philox_uniforms']['plain_ms']!r} ms; bound {p2_bound[0]!r} ms ({p2_bound[1]}) "
        f"on the ({WIDTH * HEIGHT}, {N_BOUNCES}, 21) block [{card}]")

    # K2 on the cutout scene: the 256^2 primaries, then the training views
    cut_tables = accept_tables(cut)
    cprim = primaries(cut, cut_cam, WIDTH, HEIGHT)
    c_res = traverse_alpha(*cprim, cut_tables)
    err_k2 = compare_hits(c_res, traverse_alpha_reference(*cprim, cut_tables),
                          f"K2, depth-{DEPTH} cutout, {WIDTH}x{HEIGHT} primaries", exact=True)
    k2_256 = both(lambda: traverse_alpha(*cprim, cut_tables))
    k2_256_twin = call_ms(lambda: traverse_alpha_reference(*cprim, cut_tables), 3)
    log(f"  K2 call {k2_256['call_ms']!r} ms, device {k2_256['device_ms']!r} ms ({k2_256['device_by']}), twin "
        f"{k2_256_twin!r} ms, bound {traversal_bound(c_res)[0]!r} ms; per ray {fetch_stats(c_res.fetches)} on the "
        f"{WIDTH}x{HEIGHT} cutout primaries [{card}]")
    ctrain = training_rays(cut)
    k_res = traverse_alpha(*ctrain, cut_tables)
    err_k2 = max(err_k2, compare_hits(k_res, traverse_alpha_reference(*ctrain, cut_tables),
                                      f"K2, depth-{DEPTH} cutout, {TRAIN_VIEWS} training views at {TRAIN_RES}^2",
                                      exact=True))
    bound_ms, bound_by, fetches = traversal_bound(k_res)
    results["esvo_traverse_alpha"] = dict(
        max_abs_err=err_k2, ms=call_ms(lambda: traverse_alpha(*ctrain, cut_tables), 10),
        device_ms=device_ms(lambda: traverse_alpha(*ctrain, cut_tables), calls=10)[0],
        plain_ms=call_ms(lambda: traverse_alpha_reference(*ctrain, cut_tables), 1),
        bound_ms=bound_ms, bound_by=bound_by, **fetch_stats(k_res.fetches),
        primaries_256=dict(ms=k2_256["call_ms"], device_ms=k2_256["device_ms"], plain_ms=k2_256_twin,
                           bound_ms=traversal_bound(c_res)[0], **fetch_stats(c_res.fetches)))
    log(f"  K2 {results['esvo_traverse_alpha']['ms']!r} ms (device {results['esvo_traverse_alpha']['device_ms']!r} ms), twin {results['esvo_traverse_alpha']['plain_ms']!r} ms, "
        f"bound {bound_ms!r} ms ({bound_by}: {fetches} node rows; per ray {fetch_stats(k_res.fetches)}) on the cutout "
        f"training views [{card}]")
    del c_res

    # K3r on both scenes: the 256^2 primaries, then the training views
    terrain_tables = accept_tables(scene)
    err_k3 = 0.0
    for label, rays, tables in (("terrain", prim, terrain_tables), ("cutout", cprim, cut_tables)):
        k_res, k_rec = traverse_record(*rays, tables)
        r_res, r_rec = traverse_record_reference(*rays, tables)
        err_k3 = max(err_k3, compare_hits(k_res, r_res, f"K3r, depth-{DEPTH} {label}, {WIDTH}x{HEIGHT} primaries", k_rec, r_rec,
                                          exact=True))
        log(f"  K3r {call_ms(lambda: traverse_record(*rays, tables), 50)!r} ms, twin "
            f"{call_ms(lambda: traverse_record_reference(*rays, tables), 3)!r} ms on the {WIDTH}x{HEIGHT} "
            f"{label} primaries; surfaces per ray {torch.bincount(k_rec.count).tolist()} [{card}]")
    k3 = {}
    for label, rays, tables in (("terrain", training_rays(scene), terrain_tables), ("cutout", ctrain, cut_tables)):
        k_res, k_rec = traverse_record(*rays, tables)
        r_res, r_rec = traverse_record_reference(*rays, tables)
        err_k3 = max(err_k3, compare_hits(k_res, r_res, f"K3r, depth-{DEPTH} {label}, {TRAIN_VIEWS} training views at {TRAIN_RES}^2",
                                          k_rec, r_rec, exact=True))
        k3[label] = (rays, tables, k_res)
    rays, tables, k_res = k3["terrain"]
    bound_ms, bound_by, fetches = traversal_bound(k_res, RECORD_BYTES)
    results["esvo_traverse_record"] = dict(
        max_abs_err=err_k3, ms=call_ms(lambda: traverse_record(*rays, tables), 10),
        device_ms=device_ms(lambda: traverse_record(*rays, tables), calls=10)[0],
        plain_ms=call_ms(lambda: traverse_record_reference(*rays, tables), 1),
        bound_ms=bound_ms, bound_by=bound_by, **fetch_stats(k_res.fetches))
    log(f"  K3r {results['esvo_traverse_record']['ms']!r} ms (device {results['esvo_traverse_record']['device_ms']!r} ms), twin {results['esvo_traverse_record']['plain_ms']!r} ms, "
        f"bound {bound_ms!r} ms ({bound_by}: {fetches} node rows; per ray {fetch_stats(k_res.fetches)}) on the terrain "
        f"training views [{card}]")
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
                                            f"{int(sa.sum())} of {WIDTH}x{HEIGHT} lanes active", exact=True))
        unequal = {f: int((getattr(k_st, f) != getattr(r_st, f)).sum())
                   for f in k_st._fields if getattr(k_st, f) is not None}
        if record_t:  # the emitter walk's attenuation, truncated short of the light
            max_t = dist * (1.0 - 1e-3)
            k_att = pathtracer._stateful_att_from_state(cut, so, sd, air, k_st, max_t, strict)
            r_att = pathtracer._stateful_att_from_state(cut, so, sd, air, r_st, max_t, strict)
            unequal["attenuation"] = int((k_att != r_att).sum())
        log(f"    record not bit-equal: {unequal}; surfaces per ray {torch.bincount(k_st.count).tolist()}; "
            f"budget spent on {int((k_st.w <= 0).sum())} lanes")
        if any(unequal.values()):
            raise AssertionError(f"K3s's record disagrees with its twin on the {label} walk")
        if label == "sun":
            sun_args, sun_res = sargs, k_res
        else:
            em_ms = (call_ms(lambda: traverse_shadow(*sargs), 50),
                     call_ms(lambda: traverse(*sargs[:6], 1024.0, sargs[-1]), 50),
                     call_ms(lambda: traverse_alpha(*sargs[:6], cut_tables, 1024.0, sargs[-1]), 50))
            log(f"  K3s {em_ms[0]!r} ms; on the same rays K1 {em_ms[1]!r} ms, K2 {em_ms[2]!r} ms; "
                f"the {WIDTH}x{HEIGHT} cutout emitter walk, bound {traversal_bound(k_res, SHADOW_BYTES + SHADOW_T_BYTES)[0]!r} ms "
                f"[{card}]")
    bound_ms, bound_by, fetches = traversal_bound(sun_res, SHADOW_BYTES)
    results["esvo_traverse_shadow"] = dict(
        max_abs_err=err_k3s, ms=call_ms(lambda: traverse_shadow(*sun_args), 50),
        device_ms=device_ms(lambda: traverse_shadow(*sun_args))[0],
        plain_ms=call_ms(lambda: traverse_shadow_reference(*sun_args), 3), bound_ms=bound_ms, bound_by=bound_by,
        **fetch_stats(sun_res.fetches))
    same_rays = sun_args[:6] + (1024.0,)
    k1_same = call_ms(lambda: traverse(*same_rays, sun_args[-1]), 50)
    k2_same = call_ms(lambda: traverse_alpha(*same_rays[:6], cut_tables, 1024.0, sun_args[-1]), 50)
    log(f"  K3s {results['esvo_traverse_shadow']['ms']!r} ms (device {results['esvo_traverse_shadow']['device_ms']!r} ms), twin {results['esvo_traverse_shadow']['plain_ms']!r} ms, "
        f"bound {bound_ms!r} ms ({bound_by}: {fetches} node rows; per active ray {fetch_stats(sun_res.fetches)}); "
        f"on the same rays K1 {k1_same!r} ms, K2 {k2_same!r} ms; the {WIDTH}x{HEIGHT} cutout sun walk [{card}]")

    # P1 at the probe's shape, then at the emitter grid's on the cutout's
    # supercells of its primaries' hit points (as _spatial_pick computes them)
    g = torch.Generator().manual_seed(3)
    probe = torch.randint(-2**31, 2**31 - 1, (1 << 17, 8), generator=g, dtype=torch.int32).to(dev)
    probe_idx = torch.randint(0, 1 << 17, (4096,), generator=g, dtype=torch.int32).to(dev)
    gsz = 1 << cut_em.grid_bits
    cell = torch.clamp(((hp + (0.01 * cut_em.cell_size) * hn) / cut_em.cell_size).to(torch.int32), 0, gsz - 1)
    cells = ((cell[:, 0] * gsz + cell[:, 1]) * gsz + cell[:, 2]).contiguous()
    n_cells = cells.numel()
    gathers = (("the probe's (131072, 8) int32 table, 4096 int32 indices", probe, probe_idx),
               ("the probe's table, 4096 int64 indices", probe, probe_idx.long()),
               (f"grid_idx {tuple(cut_em.grid_idx.shape)} int32, {n_cells} indices", cut_em.grid_idx, cells),
               (f"grid_w {tuple(cut_em.grid_w.shape)} float32, {n_cells} indices", cut_em.grid_w, cells))
    for label, table, idx in gathers:
        got, want = row_gather(table, idx), row_gather_reference(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"P1 disagrees with its twin on {label}")
        idx_long = idx.long()
        k = both(lambda t=table, i=idx: row_gather(t, i))
        lib = both(lambda t=table, i=idx_long: torch.index_select(t, 0, i))
        plain = call_ms(lambda t=table, i=idx: row_gather_reference(t, i))
        b_ms, b_by = gather_bound(table, idx)
        log(f"  P1 {label}: bit-equal; call {k['call_ms']!r} ms, device {k['device_ms']!r} ms ({k['device_by']}); "
            f"torch.index_select call {lib['call_ms']!r} ms, device {lib['device_ms']!r} ms ({lib['device_by']}); "
            f"twin {plain!r} ms; bound {b_ms!r} ms ({b_by}) [{card}]")
    # the emitter pick's two gathers in one launch: the main path's P1
    pair_tables = (cut_em.grid_idx, cut_em.grid_w)
    for idx in (cells, cells.long()):
        got, want = row_gather_pair(*pair_tables, idx), row_gather_pair_reference(*pair_tables, idx)
        torch.cuda.synchronize()
        if not all(torch.equal(k.view(torch.int32), r.view(torch.int32)) for k, r in zip(got, want)):
            raise AssertionError(f"P1's pair disagrees with its twin ({idx.dtype} indices)")
    cells_long = cells.long()
    k = both(lambda: row_gather_pair(*pair_tables, cells))
    lib = both(lambda: (torch.index_select(pair_tables[0], 0, cells_long),
                        torch.index_select(pair_tables[1], 0, cells_long)))
    b_ms, b_by = gather_bound(cut_em.grid_idx, cells, tables=2)
    results["row_gather"] = dict(  # the emitter pick's call until PR 10: the pair over the 256^2 lanes
        variant="row_gather_pair (grid_idx + grid_w, one launch)", max_abs_err=0.0,
        main_path="none: K6's pick reads its supercell rows inside nee_setup",
        ms=k["call_ms"], device_ms=k["device_ms"],
        plain_ms=call_ms(lambda: row_gather_pair_reference(*pair_tables, cells)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        two_index_select_ms=lib["call_ms"], two_index_select_device_ms=lib["device_ms"])
    log(f"  P1 pair grid_idx + grid_w, {n_cells} int32 and int64 indices: bit-equal; call {k['call_ms']!r} ms, "
        f"device {k['device_ms']!r} ms ({k['device_by']}); two torch.index_select call {lib['call_ms']!r} ms, "
        f"device {lib['device_ms']!r} ms ({lib['device_by']}); twin {results['row_gather']['plain_ms']!r} ms; "
        f"bound {b_ms!r} ms ({b_by}) [{card}]")
    del walks, sun_args, sun_res, first, probe, probe_idx

    # K2q in its three modes on the depth-9 plant field, and K7 on the
    # depth-9 analytic scene's primaries
    t0 = time.perf_counter()
    plant_cpu, plant_cam_cpu = plant_scene(depth=DEPTH)
    plant_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ana_cpu, ana_cam_cpu = analytic_sphere_scene(depth=DEPTH)
    ana_build_s = time.perf_counter() - t0
    plant, plant_cam = plant_cpu.to(dev), plant_cam_cpu.to(dev)
    ana, ana_cam = ana_cpu.to(dev), ana_cam_cpu.to(dev)
    log(f"  depth-{DEPTH} plant field built in {plant_build_s:.2f} s: {plant.n_nodes} nodes, "
        f"{plant.models.flags.shape[0]} models, {plant.models.quads.count} quads; analytic scene "
        f"{ana_build_s:.2f} s: {ana.n_nodes} nodes, {ana.prims.n_spheres} sphere, {ana.prims.quads.count} quad")
    plant_tables = accept_tables(plant)
    pprim = primaries(plant, plant_cam, WIDTH, HEIGHT)

    # the twin's candidates and quad tests on these rays, for the bound: a
    # candidate reads its model row; a quad model's, its quads' rows
    work = {"candidates": 0, "quad_rows": 0}
    real_accept = traversal._alpha_accept

    def counting_accept(c, s_, tables, mode, fresh, rec, inv_scale):
        lv = s_["cand"][fresh].clamp(0, tables.leaf_model.shape[0] - 1).long()
        model = tables.leaf_model[lv].clamp(0, tables.flags.shape[0] - 1).long()
        scanned = (tables.flags[model] & 1) == 0
        if mode == 1:  # a leaf that cannot reject is accepted unread
            scanned = scanned & tables.rejectable[lv]
        read = tables.rejectable[lv] if mode == 1 else torch.ones_like(scanned)
        work["candidates"] += int(read.sum())
        work["quad_rows"] += int(tables.quad_count[model][scanned].sum())
        return real_accept(c, s_, tables, mode, fresh, rec, inv_scale)

    with mock.patch.object(traversal, "_alpha_accept", counting_accept):
        r_res = traverse_alpha_reference(*pprim, plant_tables)
    k_res = traverse_alpha(*pprim, plant_tables)
    err_k2q = compare_hits(k_res, r_res, f"K2q mode 1, depth-{DEPTH} plant field, {WIDTH}x{HEIGHT} primaries",
                           exact=True)
    log(f"    hits {int(k_res.hit.sum())}, of them on a plant's quad {int(k_res.quad.found.sum())}; the twin's "
        f"candidates {work['candidates']}, quad rows tested {work['quad_rows']}")
    n_bytes_k, n_ops_k = (work["candidates"] * MODEL_ROW_BYTES + work["quad_rows"] * QUAD_ROW_BYTES,
                          work["quad_rows"] * OPS_PER_QUAD)
    fetches = int(k_res.fetches.sum())
    k2q_bound = bound(fetches * 32 + WIDTH * HEIGHT * (RAY_BYTES + QUAD_OUT_BYTES) + n_bytes_k,
                      fetches * OPS_PER_FETCH + n_ops_k)
    k2q = both(lambda: traverse_alpha(*pprim, plant_tables))
    results["esvo_traverse_models"] = dict(
        variant=f"mode 1 (the alpha accept with block models) on the {WIDTH}x{HEIGHT} depth-{DEPTH} plant primaries",
        ms=k2q["call_ms"], device_ms=k2q["device_ms"],
        plain_ms=call_ms(lambda: traverse_alpha_reference(*pprim, plant_tables), 2),
        bound_ms=k2q_bound[0], bound_by=k2q_bound[1], library_ms=None, **fetch_stats(k_res.fetches))
    log(f"  K2q mode 1 call {k2q['call_ms']!r} ms, device {k2q['device_ms']!r} ms ({k2q['device_by']}); twin "
        f"{results['esvo_traverse_models']['plain_ms']!r} ms; bound {k2q_bound[0]!r} ms ({k2q_bound[1]}: {fetches} "
        f"node rows, {work['quad_rows']} quad rows; per ray {fetch_stats(k_res.fetches)}) on the {WIDTH}x{HEIGHT} "
        f"plant primaries [{card}]")
    k_res2, k_rec2 = traverse_record(*pprim, plant_tables)
    r_res2, r_rec2 = traverse_record_reference(*pprim, plant_tables)
    err_k2q = max(err_k2q, compare_hits(k_res2, r_res2, f"K2q mode 2, depth-{DEPTH} plant field, {WIDTH}x{HEIGHT} "
                                        "primaries", k_rec2, r_rec2, exact=True))
    m2 = both(lambda: traverse_record(*pprim, plant_tables))
    log(f"  K2q mode 2 call {m2['call_ms']!r} ms, device {m2['device_ms']!r} ms; surfaces per ray "
        f"{torch.bincount(k_rec2.count).tolist()}; fetches per ray {fetch_stats(k_res2.fetches)} [{card}]")
    # mode 3: from the primaries' hits, toward the sun (strict, no t) and
    # toward random directions of the hit's hemisphere (t recorded)
    hn = resolve_hit(plant, pprim[4], pprim[5], k_res)[2]
    hp = torch.where(k_res.hit[:, None], pprim[4] + pprim[5] * k_res.t[:, None], pprim[4])
    su = torch.from_numpy(np.random.default_rng(12).random((WIDTH * HEIGHT, 5), dtype=np.float32)).to(dev)
    sun_dir = random_sun_direction(plant.sun, su[:, 0], su[:, 1]).contiguous()
    rnd = torch.from_numpy(np.random.default_rng(13).standard_normal((WIDTH * HEIGHT, 3)).astype(np.float32)).to(dev)
    rnd = rnd / rnd.norm(dim=-1, keepdim=True)
    rnd = torch.where(((rnd * hn).sum(-1) < 0)[:, None], -rnd, rnd).contiguous()
    air = torch.zeros((WIDTH * HEIGHT,), dtype=torch.int32, device=dev)
    for label, sd, strict, record_t in (("sun", sun_dir, True, False), ("hemisphere", rnd, False, True)):
        front = (sd * hn).sum(-1) > 0.0
        so = (torch.where(front[:, None], hp, hp - OFFSET * hn) + sd * OFFSET).contiguous()
        sargs = (plant.nodes, plant.root, plant.depth, plant.octree_scale, so, sd, plant_tables, air, strict,
                 record_t, 1024.0, k_res.hit & front)
        k_r3, k_st = traverse_shadow(*sargs)
        r_r3, r_st = traverse_shadow_reference(*sargs)
        err_k2q = max(err_k2q, compare_hits(k_r3, r_r3, f"K2q mode 3 {label} walk, depth-{DEPTH} plant field, "
                                            f"{int(sargs[-1].sum())} of {WIDTH}x{HEIGHT} lanes active", k_st, r_st,
                                            exact=True))
        m3 = both(lambda: traverse_shadow(*sargs))
        log(f"  K2q mode 3 {label} walk call {m3['call_ms']!r} ms, device {m3['device_ms']!r} ms; surfaces per "
            f"ray {torch.bincount(k_st.count).tolist()}; fetches per active ray {fetch_stats(k_r3.fetches)} [{card}]")
    results["esvo_traverse_models"]["max_abs_err"] = err_k2q

    # K7 on the analytic scene's primaries
    po, pd = pixel_grid_rays(ana_cam, WIDTH, HEIGHT)
    po, pd = po.contiguous(), pd.contiguous()
    k7 = intersect_prims(ana.prims, po, pd, 1024.0)
    r7 = intersect_prims_reference(ana.prims, po, pd, 1024.0)
    torch.cuda.synchronize()
    unequal = {name: int((a != b).sum()) for name, a, b in zip(("hit", "t", "mat", "normal"),
                                                               (k7[0], k7[1], k7[2], k7[4]),
                                                               (r7[0], r7[1], r7[2], r7[4]))}
    uv_err = float((k7[3] - r7[3]).abs().max())
    log(f"  K7, depth-{DEPTH} analytic scene, {WIDTH}x{HEIGHT} primaries: hits {int(k7[0].sum())} "
        f"(sphere {int((k7[0] & (k7[2] == 2)).sum())}, quad {int((k7[0] & (k7[2] == 3)).sum())}); not bit-equal "
        f"{unequal}; uv max abs diff {uv_err!r}")
    if any(unequal.values()) or not uv_err <= 1e-6:
        raise AssertionError("K7 disagrees with its twin on the analytic primaries")
    k7t = both(lambda: intersect_prims(ana.prims, po, pd, 1024.0))
    k7_bound = prim_bound(ana.prims, WIDTH * HEIGHT)
    results["prims_intersect"] = dict(
        max_abs_err=uv_err, ms=k7t["call_ms"], device_ms=k7t["device_ms"],
        plain_ms=call_ms(lambda: intersect_prims_reference(ana.prims, po, pd, 1024.0), 10),
        bound_ms=k7_bound[0], bound_by=k7_bound[1], library_ms=None)
    log(f"  K7 call {k7t['call_ms']!r} ms, device {k7t['device_ms']!r} ms ({k7t['device_by']}); twin "
        f"{results['prims_intersect']['plain_ms']!r} ms; bound {k7_bound[0]!r} ms ({k7_bound[1]}) on the "
        f"{WIDTH}x{HEIGHT} analytic primaries [{card}]")
    # K4's forward with K7's scan folded in, on the analytic line's bounces
    # (IMPORTANCE; the whole batch, K5's live lanes first after the first):
    # against its twin (which scans with K7's plain version) under K4's gate,
    # and bit for bit against K4 fed by the standalone K7 (a dead lane's hit
    # masked to a miss, as the scan skips it); timed beside that route
    ana_imp = dataclasses.replace(ana, sun_sampling=SunSampling.importance())
    ana_u = pathtracer.draw_uniforms(1, 0, WIDTH * HEIGHT, N_BOUNCES, dev)
    scan_grads = shade_gradients(pathtracer, ana_imp, po, pd, ana_u)
    scan_rows = {}
    for k, (rec, grad_args) in enumerate(zip(shade_calls(pathtracer, ana_imp, po, pd, ana_u), scan_grads), start=1):
        sc_k, st_k, u_k, res_k, is_first, may_scatter = rec[:6]
        idx_k = rec[6] if len(rec) > 6 else None  # the last bounce: its radiance stored at idx
        call = (sc_k, st_k, u_k, res_k, None, is_first, may_scatter, idx_k)
        lanes, live_k = int(st_k["throughput"].shape[0]), int(st_k["active"].sum())
        if shade_mod.launch_configs(sc_k, lanes)["forward"]["variant"] != "scan":
            raise AssertionError("K4 did not take its variant with K7's scan on the analytic scene")
        chk = check_shade(call, grad_args[5:8], grad_args[8], f"analytic bounce {k}, K7's scan folded in")
        hit7 = pathtracer._prim_hit(sc_k, st_k["origin"], st_k["dir"])
        fed_call = (sc_k, st_k, u_k, res_k, (hit7[0] & st_k["active"], *hit7[1:]), is_first, may_scatter, idx_k)
        fed, fed_res = shade_mod._forward_cuda(shade_mod._Call(*fed_call), True)
        pairs = [(f, chk["out"].state[f], fed.state[f]) for f in shade_mod.STATE_KEYS]
        pairs += [(f, getattr(chk["out"], f), getattr(fed, f)) for f in ("albedo", "hitpoint", "normal", "mat",
                                                                          "diffuse_on")]
        pairs += [("residual ints", chk["resid"].ints, fed_res.ints), ("residual floats", chk["resid"].floats,
                                                                         fed_res.floats)]
        unequal = {f: int((a.view(torch.uint8) != b.view(torch.uint8)).sum()) for f, a, b in pairs}
        if any(unequal.values()):
            raise AssertionError(f"K4 with K7's scan differs from K4 fed by K7 on analytic bounce {k}: {unequal}")
        f_t = both(lambda: shade_mod.shade(*call))
        fed_t = both(lambda: shade_mod.shade(*call[:4], pathtracer._prim_hit(sc_k, st_k["origin"], st_k["dir"]),
                                             *call[5:]))
        f_bound = shade_bound(call, chk["out"], chk["resid"], grad=False)
        scan_rows[f"bounce {k}"] = dict(
            lanes=lanes, live=live_k, max_abs_err=chk["forward_err"], ms=f_t["call_ms"], device_ms=f_t["device_ms"],
            plain_ms=call_ms(lambda: real_shade_twin(*call), 5), bound_ms=f_bound[0], bound_by=f_bound[1],
            library_ms=None, unfolded_ms=fed_t["call_ms"], unfolded_device_ms=fed_t["device_ms"])
        row = scan_rows[f"bounce {k}"]
        log(f"  K4 with K7's scan, analytic bounce {k}: {lanes} lanes, {live_k} live; against its twin: lanes not "
            f"bit-equal per field {chk['differ']}, outside rtol 1e-5 / atol 1e-6 {chk['outside']}, max abs err "
            f"{chk['forward_err']!r}; bit-equal to K4 fed by the standalone K7; call {row['ms']!r} ms, device "
            f"{row['device_ms']!r} ms ({f_t['device_by']}), twin {row['plain_ms']!r} ms, bound {row['bound_ms']!r} "
            f"ms ({row['bound_by']}); K7 + K4 fed by it: call {row['unfolded_ms']!r} ms, device "
            f"{row['unfolded_device_ms']!r} ms [{card}]")
    results["shade (K7 scan)"] = dict(scan_rows["bounce 1"], max_abs_err=max(r["max_abs_err"] for r in scan_rows.values()),
                                      analytic_bounces={b: r for b, r in scan_rows.items() if b != "bounce 1"})
    del scan_grads
    # nee_setup with K7's scan folded in, on the analytic HIGH_QUALITY line's bounce 1
    nee_phase2("analytic_hq", high_quality(ana), ana_cam, ana_u)
    nee_results()
    results["nee_setup (K7 scan)"] = dict(nee_rows["nee_setup"]["analytic_hq"])
    del ana_u
    # K8 on the depth-9 plant field's quad soup, against the plant primaries
    bvh_info = child_result("bvh")
    with np.load(bvh_path) as z:
        bvh = BVH.from_arrays(z["node_min"], z["node_max"], z["left"], z["right"], z["prim_order"]).to(dev)
        quads = make_quads(z["o"], z["u"], z["v"], z["mat"]).to(dev)
    log(f"  K8: plant_scene(depth={DEPTH}) holds {bvh_info['plants']} plants, {bvh_info['quads']} quads; "
        f"build_bvh {bvh_info['seconds']:.2f} s on the host{' (cached)' if bvh_info['cached'] else ''}: "
        f"{bvh.n_nodes} nodes, tree depth {bvh.depth}; the kernel's launch {bvh_mod.launch_attributes(bvh)}")
    bo, bd = pprim[4], pprim[5]
    t_octree = torch.where(k_res.hit, k_res.t, float("inf")).contiguous()  # quads nearer than the octree's hit
    err_k8, work8 = 0.0, {}
    for label, t_init in (("no t_init", None), ("t_init = the octree's hit t", t_octree)):
        k8 = bvh_intersect_quads(bvh, quads, bo, bd, t_init)
        r8 = bvh_intersect_reference(bvh, bo, bd, quad_prim_fn(quads), t_init, stats=work8 if t_init is None else None)
        torch.cuda.synchronize()
        unequal = {name: int((a != b).sum()) for name, a, b in zip(("hit", "t", "payload"), k8, r8)}
        log(f"  K8, {WIDTH}x{HEIGHT} plant primaries, {label}: hits {int(k8[0].sum())}; not bit-equal {unequal}")
        if any(unequal.values()):
            raise AssertionError(f"K8 disagrees with its twin on the plant primaries ({label})")
    k8t = both(lambda: bvh_intersect_quads(bvh, quads, bo, bd))
    # the rows the kernel reads: each ray the root's, each expansion its two
    # children's (a pop reads none); the twin's walk, as the JAX one, reads a
    # row on every pop besides
    rays8 = WIDTH * HEIGHT
    rows8, twin_rows8 = rays8 + 2 * work8["interior"], work8["nodes"] + 2 * work8["interior"]
    quad_bytes8 = work8["prims"] * QUAD_ROW_BYTES
    k8_bound = bound(rays8 * BVH_RAY_BYTES + rows8 * BVH_NODE_BYTES + quad_bytes8,
                     rows8 * OPS_PER_BOX + work8["prims"] * OPS_PER_QUAD)
    reread_bound = bound(rays8 * BVH_RAY_BYTES + twin_rows8 * BVH_NODE_BYTES + quad_bytes8,
                         twin_rows8 * OPS_PER_BOX + work8["prims"] * OPS_PER_QUAD)
    results["bvh_intersect"] = dict(
        max_abs_err=0.0, ms=k8t["call_ms"], device_ms=k8t["device_ms"],
        plain_ms=call_ms(lambda: bvh_intersect_reference(bvh, bo, bd, quad_prim_fn(quads)), 1),
        bound_ms=k8_bound[0], bound_by=k8_bound[1], library_ms=None, rows_per_ray=rows8 / rays8,
        twin_rows_per_ray=twin_rows8 / rays8, reread_bound_ms=reread_bound[0], tree_depth=bvh.depth,
        stack_entries=bvh.depth + 1)
    log(f"  K8 call {k8t['call_ms']!r} ms, device {k8t['device_ms']!r} ms ({k8t['device_by']}); twin "
        f"{results['bvh_intersect']['plain_ms']!r} ms; bound {k8_bound[0]!r} ms ({k8_bound[1]}: {rows8} node rows, "
        f"{rows8 / rays8!r} a ray: the root's and {work8['interior']} expansions' 2 child rows; {work8['prims']} quad "
        f"rows); the bound counting the twin's re-reads on every pop ({twin_rows8} rows, {twin_rows8 / rays8!r} a "
        f"ray) {reread_bound[0]!r} ms, on the {WIDTH}x{HEIGHT} plant primaries; no PyTorch call computes this "
        f"[{card}]")
    # K8's main path: the entry point a caller uses, once
    reset_counts()
    hit8 = bvh_intersect_quads(bvh, quads, bo, bd)[0]
    torch.cuda.synchronize()
    read_counts("the BVH walk (bvh_intersect_quads over the plant soup)", ("bvh_intersect",))
    log(f"  {int(hit8.sum())} of {WIDTH * HEIGHT} primaries hit a plant's quad")
    del k_res, r_res, k_res2, r_res2, k_rec2, r_rec2, k_r3, r_r3, k_st, r_st, k7, r7, k8, r8, bvh, quads

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
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(renderer, "render_pass", count_pass), \
            mock.patch.object(renderer, "render_pass_branched", count_branched):
        while r.step():
            torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    read_counts("the Renderer", ("esvo_traverse", "philox_uniforms", "shade", "compact_forward")
                + unpermute_fold(False, False))
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
    shades = []
    real_shade = pathtracer._shade

    def count_shade(*a, **kw):
        shades.append(1)
        return real_shade(*a, **kw)

    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(pathtracer, "_shade", count_shade):
        r = parsed.fn(parsed)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    read_counts("cli render --sun high_quality --emitter-sampling one",
                ("esvo_traverse_alpha", "esvo_traverse_shadow", "philox_uniforms", "shade", "nee_setup",
                 "nee_resolve"))
    log(f"  _shade calls {len(shades)}; nee_setup {nee_mod.nee.setup_launches}, nee_resolve "
        f"{nee_mod.nee.resolve_launches}, K3s {traverse_shadow.launches} (one walk per call for the sun and "
        f"emitter faces together), P1 {row_gather.launches} (K6's pick reads its rows inside nee_setup)")
    if not (nee_mod.nee.setup_launches == nee_mod.nee.resolve_launches == len(shades)) or row_gather.launches:
        raise AssertionError("the light-sampling render did not run one nee_setup and one nee_resolve per _shade "
                             "call, or launched P1")
    frame = r.framebuffer
    if r.spp != 20 or not bool(torch.isfinite(frame).all()) or float(frame.mean()) <= 0.0:
        raise AssertionError("the light-sampling frame is not finite with a positive mean at 20 spp")
    log(f"  spp {r.spp}; frame mean {float(frame.mean())!r}, finite; {r.scene.emitters.count} emitters; "
        f"{render_s:.2f} s with the scene build [{card}]")

    # ---- 3c. the block-model entry point
    argv = ["render", "--scene", "plant", "--depth", str(DEPTH), "--width", str(WIDTH), "--height", str(HEIGHT),
            "--spp", "20", "--sun", "high_quality", "--device", "cuda",
            "-o", os.path.join(out_dir, f"plant_d{DEPTH}_{WIDTH}.ppm")]
    log(f"phase 3c block models: cli {' '.join(argv)}")
    parsed = cli.build_parser().parse_args(argv)
    reset_counts()
    t0 = time.perf_counter()
    r = parsed.fn(parsed)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    read_counts("cli render --scene plant --sun high_quality",
                ("esvo_traverse_models (mode 1)", "esvo_traverse_models (mode 3)", "philox_uniforms", "shade"))
    frame = r.framebuffer
    if r.spp != 20 or not bool(torch.isfinite(frame).all()) or float(frame.mean()) <= 0.0:
        raise AssertionError("the plant frame is not finite with a positive mean at 20 spp")
    log(f"  spp {r.spp}; frame mean {float(frame.mean())!r}, finite; {render_s:.2f} s with the scene build [{card}]")

    # ---- 3d. the preview at the reference window: the walk, then K10
    from octree_pathtracing_tpu_torch.render import preview as preview_render

    preview_calls = []  # (scene, dirs, walk, out) of each K10 call on a preview path
    preview_frames = []  # (scene, camera, width, height) of each preview_image call
    real_preview_image = preview_render.preview_image

    def recording_preview_shade(sc, d, res):
        out = preview_mod.preview_shade(sc, d, res)
        preview_calls.append((sc, d, res, out))
        return out

    def recording_preview_image(*a):
        preview_frames.append(a)
        return real_preview_image(*a)

    def walk_kernel(sc) -> str:
        if sc.opaque_only:
            return "esvo_traverse"
        return "esvo_traverse_models (mode 1)" if sc.models is not None else "esvo_traverse_alpha"

    preview_rows = {}

    def preview_line(label: str, run):
        """``run()`` draws one preview through the entry point; then K10 is
        held against its twin on every pixel and timed on that call's walk,
        and the preview itself is timed eager (median of 5 after a warm-up)."""
        preview_calls.clear()
        preview_frames.clear()
        reset_counts()
        with mock.patch.object(preview_render, "preview_shade", recording_preview_shade), \
                mock.patch.object(preview_render, "preview_image", recording_preview_image):
            img = run()
        torch.cuda.synchronize()
        sc, d, res, out = preview_calls[-1]
        read_counts(f"the preview of {label}", (walk_kernel(sc), "preview_shade"))
        if preview_mod.preview_shade.launches != 1:
            raise AssertionError(f"the preview of {label} launched K10 {preview_mod.preview_shade.launches} times")
        want = real_preview_twin(sc, d, res)
        unequal = int((out != want).any(dim=1).sum())
        err = float((out - want).abs().max())
        if unequal or tuple(img.shape) != (PREVIEW_H, PREVIEW_W, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"the preview of {label}: K10 differs from its twin on {unequal} pixels "
                                 f"(max abs {err!r}), or the frame is not a finite {PREVIEW_W}x{PREVIEW_H}")
        sc_f, cam_f, w_f, h_f = preview_frames[-1]
        eager = host_ms(lambda: real_preview_image(sc_f, cam_f, w_f, h_f))
        k10 = both(lambda: preview_mod.preview_shade(sc, d, res))
        # the same call on 3 copies of its inputs in turn: ~115 MB (~150 with
        # quads) > the 50 MB L2, so each call reads its inputs from HBM as
        # the bound counts them, where the repeated call finds them in L2
        copies = [(d.clone(), res._replace(quad=None if res.quad is None else type(res.quad)(*(x.clone() for x in res.quad)),
                                           **{f: getattr(res, f).clone() for f in ("hit", "face_id", "uv", "leaf_value")}))
                  for _ in range(3)]
        turn = iter(range(10**9))
        cold, _ = device_ms(lambda: preview_mod.preview_shade(sc, *copies[next(turn) % 3]))
        del copies
        b_ms, b_by, texels = preview_bound(sc, res)
        row = dict(lanes=int(d.shape[0]), hits=int(res.hit.sum()), texels=texels, max_abs_err=err,
                   ms=k10["call_ms"], device_ms=cold, device_ms_l2=k10["device_ms"],
                   plain_ms=call_ms(lambda: real_preview_twin(sc, d, res), 5),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None, preview_ms=statistics.median(eager))
        preview_rows[label] = row
        log(f"  {label}: {row['hits']} of {row['lanes']} pixels hit, {texels} distinct texels; K10 bit-equal to its "
            f"twin on every pixel; preview {row['preview_ms']!r} ms eager (median of {len(eager)}: "
            f"{[round(t, 3) for t in eager]}); K10 call {row['ms']!r} ms, device {row['device_ms']!r} ms over 3 "
            f"copies of its inputs in turn, {row['device_ms_l2']!r} ms repeating one call (its inputs in L2) "
            f"({k10['device_by']}), bound {b_ms!r} ms ({b_by}), twin {row['plain_ms']!r} ms [{card}]")

    log(f"phase 3d preview at {PREVIEW_W}x{PREVIEW_H} (RenderConfig's window), depth {DEPTH}")
    for label, sc, camera in (("chunk", scene, cam), ("cutout", cut, cut_cam), ("plant", plant, plant_cam)):
        preview_line(label, lambda: preview_render.preview_image(sc, camera, PREVIEW_W, PREVIEW_H))
    child_result("world")  # the region file, written by the host process phase 0 started
    argv = ["preview", "--world", world_path, "--depth", str(WORLD_DEPTH), "--width", str(PREVIEW_W),
            "--height", str(PREVIEW_H), "--device", "cuda", "-o", os.path.join(out_dir, "world_preview.ppm")]
    log(f"  cli {' '.join(argv)}")
    parsed = cli.build_parser().parse_args(argv)
    preview_line("world", lambda: parsed.fn(parsed))
    preview_calls.clear()
    preview_frames.clear()
    results["preview_shade"] = dict(preview_rows["chunk"], lines=preview_rows,
                                    max_abs_err=max(r["max_abs_err"] for r in preview_rows.values()))

    # ---- 3e. checkpoint and resume through the CLI
    ck = os.path.join(out_dir, "resume_ck.npz")
    common = ["--scene", "chunk", "--depth", str(DEPTH), "--width", str(WIDTH), "--height", str(HEIGHT),
              "--device", "cuda"]
    resumed = {}
    for name, spp, extra in (("checkpointed", 4, ["--checkpoint", ck]), ("resumed", 8, ["--resume", ck]),
                             ("uninterrupted", 8, [])):
        argv = ["render", *common, "--spp", str(spp), *extra, "-o", os.path.join(out_dir, f"resume_{name}.ppm")]
        if name == "checkpointed":
            log(f"phase 3e checkpoint and resume: cli {' '.join(argv)}")
        else:
            log(f"  cli {' '.join(argv)}")
        parsed = cli.build_parser().parse_args(argv)
        reset_counts()
        r = parsed.fn(parsed)
        torch.cuda.synchronize()
        read_counts(f"cli render ({name})", ("esvo_traverse", "philox_uniforms", "shade", "compact_forward"))
        resumed[name] = r
    a, b = resumed["resumed"], resumed["uninterrupted"]
    if not (os.path.exists(ck) and a.spp == b.spp == 8 and a.counter == b.counter
            and torch.equal(a.framebuffer, b.framebuffer)):
        raise AssertionError("the frame resumed from a 4-spp checkpoint is not the uninterrupted 8-spp frame")
    log(f"  resumed from 4 to {a.spp} spp (draw counter {a.counter}): bit-equal to the uninterrupted frame, "
        f"mean {float(a.framebuffer.mean())!r}; the checkpoint {os.path.getsize(ck)} bytes")
    del resumed, a, b, r

    # ---- 4. frame parity: kernel paths against twin paths
    w = h = 64
    u = torch.from_numpy(np.random.default_rng(7).random((w * h, N_BOUNCES, 21), dtype=np.float32)).to(dev)
    for label, sc, camera in (("terrain", scene, cam), ("cutout", cut, cut_cam),
                              ("terrain HIGH_QUALITY + ONE", high_quality(scene, "one"), cam),
                              ("cutout HIGH_QUALITY + ONE", high_quality(cut, "one"), cut_cam),
                              ("plant field HIGH_QUALITY", plant, plant_cam), ("analytic", ana, ana_cam),
                              ("analytic HIGH_QUALITY", high_quality(ana), ana_cam)):
        po, pd = pixel_grid_rays(camera, w, h)
        got = trace_paths(sc, po, pd, u)
        with twins():
            want = trace_paths(sc, po, pd, u)
        bad = int((~torch.isclose(got, want, rtol=2e-3, atol=2e-3).all(dim=-1)).sum())
        log(f"phase 4 frame parity, {label} {w}x{h}x{N_BOUNCES}: bad lanes {bad}/{w * h}, "
            f"max abs diff {float((got - want).abs().max())!r}")
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"kernel frame disagrees with the twin frame ({label})")

    # ---- 5. timing of the forward frame
    fo, fd = pixel_grid_rays(cam, WIDTH, HEIGHT)
    fu = pathtracer.draw_uniforms(1, 0, WIDTH * HEIGHT, N_BOUNCES, dev)
    _, live = trace_paths_census(scene, fo, fd, fu)
    times = []
    reset_counts()
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace_paths(scene, fo, fd, fu)
        torch.cuda.synchronize()
        if i:  # the first run is the warm-up
            times.append((time.perf_counter() - t0) * 1e3)
    read_counts("the forward frame", ("esvo_traverse", "shade", "compact_forward") + unpermute_fold(False, False))
    frame_ms = statistics.median(times)
    rays_nominal = WIDTH * HEIGHT * N_BOUNCES
    rays_live = int(live.sum())
    log(f"phase 5 forward timing [{card}]")
    log(f"  frame_ms {frame_ms!r} (median of {len(times)}: {[round(t, 3) for t in times]}) "
        f"depth {DEPTH} {WIDTH}x{HEIGHT} bounces {N_BOUNCES} [{card}]")
    log(f"  rays_nominal {rays_nominal} rays_per_s_nominal {rays_nominal / (frame_ms / 1e3)!r} [{card}]")
    log(f"  rays_live {rays_live} live_per_bounce {live.tolist()} "
        f"rays_per_s_live {rays_live / (frame_ms / 1e3)!r} [{card}]")

    def frame_launches(fn):
        """The device activities of one call of ``fn``, through K4's kernels
        and through its eager twin (the shading the main path ran before)."""
        def synced():
            fn()
            torch.cuda.synchronize()

        kernel = counted_launches(synced, others=True)
        with k4_twins():
            twin = counted_launches(synced)
        return kernel, twin

    k_launch, t_launch = frame_launches(lambda: trace_paths(scene, fo, fd, fu))
    log(f"  launches per headline forward frame (torch.profiler): {k_launch} through K4's kernels, {t_launch} "
        f"through K4's eager twin (the parent's shading) [{card}]")

    # ---- 6. bench.py's fwd+bwd step
    log(f"phase 6 fwd+bwd (bench.py:61-71) [{card}]")

    def fwdbwd(sc, o, d, uu):
        p = {"atlas": sc.atlas.detach().clone().requires_grad_(True),
             "emittance": sc.materials.emittance.detach().clone().requires_grad_(True)}
        loss = trace_paths(apply_params(sc, p), o, d, uu).mean()
        loss.backward()
        return loss.detach(), p["atlas"].grad, p["emittance"].grad

    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g_atlas, g_emit = fwdbwd(scene, fo, fd, fu)
        torch.cuda.synchronize()
        if i:  # the first run is the warm-up
            times.append((time.perf_counter() - t0) * 1e3)
    read_counts("the fwd+bwd step",
                ("esvo_traverse", "shade", "shade_backward") + K5_PATH + unpermute_fold(False, True))
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
    k_launch, t_launch = frame_launches(lambda: fwdbwd(scene, fo, fd, fu))
    log(f"  launches per headline fwd+bwd step (torch.profiler): {k_launch} through K4's kernels, {t_launch} "
        f"through K4's eager twins (the parent's shading) [{card}]")

    po, pd = pixel_grid_rays(cam, w, h)
    got = fwdbwd(scene, po, pd, u)
    with k4_twins(), mock.patch.object(pathtracer, "traverse", traverse_reference):
        want = fwdbwd(scene, po, pd, u)
    for name, g, wg in zip(("loss", "atlas", "emittance"), got, want):
        torch.testing.assert_close(g, wg, rtol=1e-5, atol=1e-7, msg=lambda m, name=name: f"{name}: {m}")
    log(f"  gradient through the kernels = through the twins at {w}x{h} (rtol 1e-5, atol 1e-7): "
        f"atlas max abs diff {float((got[1] - want[1]).abs().max())!r}, "
        f"emittance max abs diff {float((got[2] - want[2]).abs().max())!r}")

    def light_launches(fn):
        """The device activities of one call of ``fn`` through the
        next-event kernels and through their plain version (the eager
        next-event path the light lines ran before them)."""
        def synced():
            fn()
            torch.cuda.synchronize()

        kernel = counted_launches(synced)
        with nee_plain():
            plain = counted_launches(synced)
        return kernel, plain

    def against_unfolded(label, step, fn):
        """``fn()`` (a line's forward frame or fwd+bwd step) against the same
        through the route before the folds (``utils/timing.unfolded``: K7
        launched and handed to K4 and to the walks, the compaction an
        autograd node with ``compact_backward``): the radiance (the loss)
        bit for bit, the gradients within rtol 1e-5 / atol 1e-7 (K4's
        backward adds them with float atomics) with the elements that are not
        bit-equal counted."""
        got = fn()
        with unfolded(pathtracer):
            want = fn()
        if step == "forward":
            if not torch.equal(got, want):
                raise AssertionError(f"the {label} forward frame differs from the frame before the folds")
            log(f"  {label} forward: radiance bit-equal to the route before the folds")
            return
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"the {label} fwd+bwd loss differs from the route before the folds")
        again = fn()  # the same route twice: what the float atomics' order alone moves
        differ = {}
        for g_name, g, wg, ag in zip(("atlas", "emittance"), got[1:], want[1:], again[1:]):
            torch.testing.assert_close(g, wg, rtol=1e-5, atol=1e-7,
                                       msg=lambda m, g_name=g_name: f"{label} {g_name} against the unfolded route: {m}")
            differ[g_name] = (f"{int((g != wg).sum())} of {g.numel()} elements not bit-equal, max abs diff "
                              f"{float((g - wg).abs().max())!r} (two runs of the folded route: "
                              f"{int((g != ag).sum())} not bit-equal)")
        log(f"  {label} fwd+bwd against the route before the folds: the loss bit-equal; gradients {differ}")

    def time_line(label, sc, lo, ld, required, what):
        """One line at phase 5's shape, forward and fwd+bwd: median of 5 after
        a warm-up, rays/s, peak memory, the launches each path must show
        (``required``, K4's, and the next-event kernels where the scene
        samples light, whose launches per frame are then also counted through
        the kernels and through their plain version)."""
        light = nee_mod.nee_plan(sc) is not None
        prims = sc.prims is not None
        _, live = trace_paths_census(sc, lo, ld, fu)
        rays_live = int(live.sum())
        for step, fn in (("forward", lambda: trace_paths(sc, lo, ld, fu)),
                         ("fwd+bwd", lambda: fwdbwd(sc, lo, ld, fu))):
            need = (required + ("shade", "compact_forward") + (("nee_setup", "nee_resolve") if light else ())
                    + unpermute_fold(light, step == "fwd+bwd"))
            need += (("shade (K7 scan)",) + (("nee_setup (K7 scan)",) if light else ())) if prims else ()
            if step == "fwd+bwd":  # compact_backward's work in the stores of K4's backward and nee_backward
                need += (("shade_backward", "shade_backward (src stores)")
                         + (("nee_backward", "nee_backward (src stores)") if light else ()))
            reset_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            times = []
            for i in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                if i:  # the first run is the warm-up
                    times.append((time.perf_counter() - t0) * 1e3)
            read_counts(f"the {label} line, {step}", need)
            finite = torch.isfinite(out).all() if step == "forward" else all(torch.isfinite(x).all() for x in out)
            if not bool(finite):
                raise AssertionError(f"the {label} line's {step} is not finite")
            ms = statistics.median(times)
            log(f"  {label} {step}_ms {ms!r} (median of {len(times)}: {[round(t, 3) for t in times]}) "
                f"{what} {WIDTH}x{HEIGHT} bounces {N_BOUNCES}; "
                f"rays_per_s_nominal {rays_nominal / (ms / 1e3)!r} rays_per_s_live {rays_live / (ms / 1e3)!r} "
                f"(live per bounce {live.tolist()}); max_memory_allocated "
                f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB [{card}]")
            if light:
                k_launch, p_launch = light_launches(fn)
                log(f"  launches per {label} {step} frame (torch.profiler): {k_launch} through the next-event "
                    f"kernels, {p_launch} through their plain version [{card}]")
            else:
                log(f"  launches per {label} {step} frame (torch.profiler): "
                    f"{counted_launches(lambda: (fn(), torch.cuda.synchronize()))} [{card}]")
            against_unfolded(label, step, fn)
            if prims and step == "forward":  # the scanning K4's frame: its device floor
                eager_f = fn()
                graph_f, replayed_f = capture_frame(fn)
                replayed_f.view(torch.uint8).fill_(0xFF)
                runs = replay_ms(graph_f)
                torch.cuda.synchronize()
                if not torch.equal(replayed_f, eager_f):
                    raise AssertionError(f"the replayed {label} forward frame is not bit-equal to the eager frame")
                log(f"  {label} forward frame replayed from a CUDA graph: median {statistics.median(runs)!r} ms "
                    f"({[round(t, 4) for t in runs]}); bit-equal to the eager frame [{card}]")
                del graph_f, replayed_f, eager_f

    # ---- 6a. no host read in a frame, and the forward frame as a CUDA graph
    log(f"phase 6a frames without a host read; the headline forward frame as a CUDA graph [{card}]")
    for label, sc in (("headline", scene), ("NEE (HIGH_QUALITY)", high_quality(scene))):
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # any read of the card from the host raises
        try:
            trace_paths(sc, fo, fd, fu)
            fwdbwd(sc, fo, fd, fu)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        read_counts(f"the {label} frame, forward and fwd+bwd, under set_sync_debug_mode('error')",
                    ("esvo_traverse", "shade", "shade_backward") + K5_PATH + unpermute_fold(label != "headline", True))
        log(f"  {label}: forward and fwd+bwd ran with the sync debug mode at 'error': no host read")
    eager = trace_paths(scene, fo, fd, fu)
    reset_counts()
    graph, replayed = capture_frame(lambda: trace_paths(scene, fo, fd, fu))
    read_counts("the captured headline forward frame", ("esvo_traverse", "shade", "compact_forward")
                + unpermute_fold(False, False))
    replayed.view(torch.uint8).fill_(0xFF)  # spoiled: the replays must write it again
    graph_runs = replay_ms(graph)
    torch.cuda.synchronize()
    if not torch.equal(replayed, eager):
        raise AssertionError("the replayed headline frame is not bit-equal to the eager frame")
    graph_ms = statistics.median(graph_runs)
    log(f"  headline forward frame replayed from a CUDA graph: median {graph_ms!r} ms (device floor; "
        f"{[round(t, 4) for t in graph_runs]}) beside {frame_ms!r} ms eager (phase 5): the device busy "
        f"{graph_ms / frame_ms:.3f} of the eager frame; the replay bit-equal to the eager frame [{card}]")
    del graph, replayed, eager

    # the headline's and config 3's fwd+bwd frames (config 3: the sun and
    # one-emitter NEE, nee_backward's cooperative launch on every bounce)
    # captured whole and replayed; each line's K4 and nee_backward store
    # compact_backward's work through src
    def fwd_bwd_replay(label, sc, required):
        p_ = {"atlas": sc.atlas.detach().clone().requires_grad_(True),
              "emittance": sc.materials.emittance.detach().clone().requires_grad_(True)}

        def step():
            rad = trace_paths(apply_params(sc, p_), fo, fd, fu)
            rad.mean().backward()
            return rad

        eager_r = step().detach().clone()
        grads = {k: v.grad.clone() for k, v in p_.items()}
        eager_ms = statistics.median(host_ms(lambda: fwdbwd(sc, fo, fd, fu)))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the default stream, as capture asks
            for v in p_.values():
                v.grad = None
            step()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        for v in p_.values():
            v.grad = None
        reset_counts()
        graph_b = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph_b):
            rad_b = step()
        read_counts(f"the captured {label} fwd+bwd frame", required)
        rad_b.detach().fill_(float("nan"))  # spoiled: the replays must write them again
        for v in p_.values():
            v.grad.fill_(float("nan"))
        runs = replay_ms(graph_b)
        torch.cuda.synchronize()
        if not torch.equal(rad_b.detach(), eager_r):
            raise AssertionError(f"the replayed {label} fwd+bwd frame's radiance is not bit-equal to the eager frame's")
        for k, v in p_.items():
            torch.testing.assert_close(v.grad, grads[k], rtol=1e-5, atol=1e-7,
                                       msg=lambda m, k=k: f"the replayed {label} fwd+bwd frame's {k} gradient: {m}")
        ms = statistics.median(runs)
        log(f"  {label}'s fwd+bwd frame replayed from a CUDA graph: median {ms!r} ms "
            f"({[round(t, 4) for t in runs]}) beside {eager_ms!r} ms eager: the device busy "
            f"{ms / eager_ms:.3f} of the eager step; the radiance bit-equal to the eager frame's, the gradients "
            f"within rtol 1e-5 / atol 1e-7 [{card}]")

    fwd_bwd_replay("the headline", scene, ("esvo_traverse", "shade", "shade_backward", "shade_backward (src stores)",
                                           "compact_forward") + unpermute_fold(False, True))
    fwd_bwd_replay("config 3", high_quality(scene, "one"),
                   ("esvo_traverse", "shade", "shade_backward", "shade_backward (src stores)",
                    "nee_backward (src stores)", "compact_forward") + NEE_KERNELS + unpermute_fold(True, True))
    against_unfolded("headline", "forward", lambda: trace_paths(scene, fo, fd, fu))
    against_unfolded("headline", "fwd+bwd", lambda: fwdbwd(scene, fo, fd, fu))

    # ---- 6b. bench.py's NEE and cutout lines and BASELINE's config 3
    log(f"phase 6b light sampling at bench.py's shapes [{card}]: emitters E = "
        f"{high_quality(scene, 'one').emitters.count} (depth-{DEPTH} terrain), "
        f"{high_quality(cut, 'one').emitters.count} (depth-{DEPTH} cutout)")
    for name, which, sampling in LIGHT_CELLS:
        sc = high_quality(scene if which == "terrain" else cut, sampling)
        camera = cam if which == "terrain" else cut_cam
        lo, ld = pixel_grid_rays(camera, WIDTH, HEIGHT)
        required = (("esvo_traverse",) if which == "terrain" else ("esvo_traverse_alpha", "esvo_traverse_shadow"))
        time_line(name, sc, lo, ld, required, f"{which} HIGH_QUALITY emitters={sampling} depth {DEPTH}")
        # the gradient through the kernels against the gradient through the plain versions
        po, pd = pixel_grid_rays(camera, w, h)
        got = fwdbwd(sc, po, pd, u)
        with twins():
            want = fwdbwd(sc, po, pd, u)
        for g_name, g, wg in zip(("loss", "atlas", "emittance"), got, want):
            torch.testing.assert_close(g, wg, rtol=1e-5, atol=1e-7, msg=lambda m, g_name=g_name: f"{name} {g_name}: {m}")
        log(f"  {name}: gradient through the kernels = through the plain versions at {w}x{h} (rtol 1e-5, atol "
            f"1e-7): atlas max abs diff {float((got[1] - want[1]).abs().max())!r}, emittance max abs diff "
            f"{float((got[2] - want[2]).abs().max())!r}")

    # ---- 6c. the block-model and primitive lines
    log(f"phase 6c block models and primitives at bench.py's shapes [{card}]")
    for name, which, sun in MODEL_CELLS:
        sc, camera = (plant, plant_cam) if which == "plant" else (ana, ana_cam)
        sc = dataclasses.replace(sc, sun_sampling=getattr(SunSampling, sun)())
        lo, ld = pixel_grid_rays(camera, WIDTH, HEIGHT)
        if which == "plant":
            required = ("esvo_traverse_models (mode 1)", "esvo_traverse_models (mode 3)")
        else:  # K7's scan inside K4's forward (and nee_setup on the HIGH_QUALITY line): no K7 launch
            required = ("esvo_traverse",)
        time_line(name, sc, lo, ld, required, f"{which} {sun.upper()} depth {DEPTH}")

    # ---- 7. the training entry point
    model_modes = tuple(f"esvo_traverse_models (mode {m})" for m in (1, 2, 3))
    for scene_name, views, res_px, steps, required in (
            ("chunk", TRAIN_VIEWS, TRAIN_RES, TRAIN_STEPS, ("esvo_traverse", "esvo_traverse_record", "philox_uniforms")),
            ("cutout", TRAIN_VIEWS, TRAIN_RES, TRAIN_STEPS,
             ("esvo_traverse_alpha", "esvo_traverse_record", "philox_uniforms")),
            ("plant", 2, 128, 2, model_modes + ("philox_uniforms",))):
        out = os.path.join(out_dir, f"params_{scene_name}.npz")
        argv = ["train", "--scene", scene_name, "--depth", str(DEPTH), "--views", str(views),
                "--width", str(res_px), "--height", str(res_px), "--steps", str(steps),
                "--device", "cuda", "-o", out]
        log(f"phase 7 training: cli {' '.join(argv)}")
        parsed = cli.build_parser().parse_args(argv)
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = parsed.fn(parsed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        read_counts(f"cli train --scene {scene_name}", required + ("shade", "shade_backward"))
        saved = load_arrays(out)
        if not all(np.isfinite(res.losses)) or len(res.losses) != steps:
            raise AssertionError(f"training losses not finite: {res.losses}")
        if saved["atlas"].shape != tuple(res.params["atlas"].shape) or not np.isfinite(saved["atlas"]).all():
            raise AssertionError("trained parameters were not written")
        log(f"  losses {res.losses}; wall s per step {res.step_seconds}; whole command {wall:.2f} s; "
            f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB [{card}]")

    # ---- 8. the world path: a synthesized survival region at its full size
    def tensor_bytes(x) -> int:
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if dataclasses.is_dataclass(x):
            return sum(tensor_bytes(getattr(x, f.name)) for f in dataclasses.fields(x))
        if isinstance(x, tuple):
            return sum(tensor_bytes(v) for v in x)
        return 0

    info = child_result("world")
    log(f"phase 8 world: {os.path.relpath(world_path)}, {info['bytes']} bytes, {WORLD_CHUNKS}x{WORLD_CHUNKS} chunks "
        f"of sections -4..19 ({WORLD_CHUNKS * 16}x384x{WORLD_CHUNKS * 16} blocks), {info['voxels']} not air; "
        f"synthesized in {info['seconds']:.2f} s{' (cached)' if info['cached'] else ''} from seed {WORLD_SEED}; "
        f"blocks {info['counts']}")
    with open(world_path, "rb") as f:
        buf = f.read()
    t0 = time.perf_counter()
    sections, parser, why = mca.parse_sections(buf)
    parse_s = time.perf_counter() - t0
    log(f"  parser: {parser} ({why or 'built and ran'}), {len(sections)} sections in {parse_s:.2f} s")
    t0 = time.perf_counter()
    tree, bmap = mca.build_region_octree(buf)
    region_s = time.perf_counter() - t0
    log(f"  build_region_octree {region_s:.2f} s (parse, remap and a depth-{tree.depth} octree build): "
        f"{tree.n_nodes} nodes, {len(bmap)} blockstates")
    del sections, tree, buf
    t0 = time.perf_counter()
    world_cpu, world_cam_cpu = minecraft_scene_from_region(world_path, depth=WORLD_DEPTH)
    scene_s = time.perf_counter() - t0
    world, world_cam = high_quality(world_cpu.to(dev), "one"), world_cam_cpu.to(dev)
    bounce_kernel = "esvo_traverse" if world.opaque_only else "esvo_traverse_alpha"
    sun_kernel = "esvo_traverse" if world.shadow_binary else "esvo_traverse_shadow"
    log(f"  minecraft_scene_from_region {scene_s:.2f} s: {world.n_nodes} nodes, {world.materials.count} materials, "
        f"{world.emitters.count} emitters; opaque_only={world.opaque_only} shadow_binary={world.shadow_binary}, "
        f"so the bounces run {bounce_kernel} and the sun walks {sun_kernel}; "
        f"{tensor_bytes(world) / 2**20:.1f} MiB of scene on the card [{card}]")

    argv = ["render", "--world", world_path, "--depth", str(WORLD_DEPTH), "--width", str(WIDTH), "--height", str(HEIGHT),
            "--spp", "20", "--sun", "high_quality", "--emitter-sampling", "one", "--device", "cuda",
            "-o", os.path.join(out_dir, f"world_d{WORLD_DEPTH}_{WIDTH}.ppm")]
    log(f"  8a cli {' '.join(argv)}")
    parsed = cli.build_parser().parse_args(argv)
    reset_counts()
    t0 = time.perf_counter()
    r = parsed.fn(parsed)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    read_counts("cli render --world --sun high_quality --emitter-sampling one",
                (bounce_kernel, sun_kernel, "philox_uniforms", "shade", "nee_setup", "nee_resolve"))
    frame = r.framebuffer
    if r.spp != 20 or not bool(torch.isfinite(frame).all()) or float(frame.mean()) <= 0.0:
        raise AssertionError("the world frame is not finite with a positive mean at 20 spp")
    log(f"  spp {r.spp}; frame mean {float(frame.mean())!r}, finite; {render_s:.2f} s with the scene build [{card}]")
    del r, frame

    argv = ["info", "--world", world_path, "--depth", str(WORLD_DEPTH)]
    log(f"  8b cli {' '.join(argv)}")
    parsed = cli.build_parser().parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()) as text:
        parsed.fn(parsed)
    log("    " + text.getvalue().strip().replace("\n", "\n    "))
    if f"nodes={world.n_nodes}" not in text.getvalue():
        raise AssertionError("cli info --world reports another octree")

    w = h = 64
    po, pd = pixel_grid_rays(world_cam, w, h)
    got = trace_paths(world, po, pd, u)
    with twins():
        want = trace_paths(world, po, pd, u)
    bad = int((~torch.isclose(got, want, rtol=2e-3, atol=2e-3).all(dim=-1)).sum())
    log(f"  8c frame parity, world HIGH_QUALITY + ONE {w}x{h}x{N_BOUNCES}: bad lanes {bad}/{w * h}, "
        f"max abs diff {float((got - want).abs().max())!r}")
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError("the world's kernel frame disagrees with its twin frame")

    lo, ld = pixel_grid_rays(world_cam, WIDTH, HEIGHT)
    time_line("world", world, lo, ld, (bounce_kernel, sun_kernel), f"HIGH_QUALITY emitters=one depth {WORLD_DEPTH}")
    nee_phase2("world", world, world_cam, fu)
    nee_results()
    del world, world_cpu

    out = os.path.join(out_dir, "params_world.npz")
    argv = ["train", "--world", world_path, "--depth", str(WORLD_DEPTH), "--views", "2", "--width", "128",
            "--height", "128", "--steps", "2", "--device", "cuda", "-o", out]
    log(f"  8e cli {' '.join(argv)}")
    parsed = cli.build_parser().parse_args(argv)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = parsed.fn(parsed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    read_counts("cli train --world", (bounce_kernel, "esvo_traverse_record", "philox_uniforms", "shade", "shade_backward"))
    if not all(np.isfinite(res.losses)) or len(res.losses) != 2 or not np.isfinite(load_arrays(out)["atlas"]).all():
        raise AssertionError(f"world training failed: losses {res.losses}")
    log(f"  losses {res.losses}; wall s per step {res.step_seconds}; whole command {wall:.2f} s with the scene "
        f"build; peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB [{card}]")

    # ---- 9. the sharded steps: two ranks share the card through gloo
    from octree_pathtracing_tpu_torch.parallel import render_loss, spawn_ranks

    b9 = WIDTH * HEIGHT
    o9, d9 = pixel_grid_rays(cam, WIDTH, HEIGHT)
    reset_counts()
    u9 = pathtracer.draw_uniforms(9, 0, SHARD_S * b9, N_BOUNCES, dev).reshape(SHARD_S, b9, N_BOUNCES, -1)
    torch.cuda.synchronize()
    read_counts("phase 9's uniforms", ("philox_uniforms",))
    o9s, d9s = o9[None].expand(SHARD_S, b9, 3).contiguous(), d9[None].expand(SHARD_S, b9, 3).contiguous()
    t9 = torch.full((SHARD_S, b9, 3), 0.25, device=dev)
    log(f"phase 9 sharded steps: 2 ranks spawned (torch.multiprocessing, gloo) on one card, the headline "
        f"(depth {DEPTH}, {WIDTH}x{HEIGHT} lanes, S = {SHARD_S}, {N_BOUNCES} bounces), the libraries built in "
        f"phase 1")
    t0 = time.perf_counter()
    ranks = spawn_ranks(sharded_rank, 2, "gloo", (scene_cpu, o9s.cpu(), d9s.cpu(), u9.cpu(), t9.cpu(), (1, 2), (1,),
                                                  SHARD_TRAIN_S), timeout=600)
    spawn_s = time.perf_counter() - t0
    want = sum(trace_paths(scene, o9, d9, u9[k]) for k in range(SHARD_S)) / SHARD_S
    p9 = {"atlas": scene.atlas.detach().requires_grad_(True),
          "emittance": scene.materials.emittance.detach().requires_grad_(True)}
    n9 = SHARD_TRAIN_S
    flat9 = lambda x: x[:n9].reshape((n9 * b9,) + tuple(x.shape[2:]))  # noqa: E731
    loss9 = render_loss(scene, p9, flat9(o9s), flat9(d9s), flat9(u9), flat9(t9))
    g9 = dict(zip(("atlas", "emittance"), torch.autograd.grad(loss9, [p9["atlas"], p9["emittance"]])))
    want_np = want.cpu().numpy()
    for r in ranks:
        for sp in (1, 2):
            err = float(np.abs(r["render"][sp] - want_np).max())
            if not np.allclose(r["render"][sp], want_np, rtol=1e-6, atol=1e-6):
                raise AssertionError(f"rank {r['rank']}'s sharded render (sp = {sp}) differs from the unsharded "
                                     f"average by up to {err!r}")
        loss_r, grads_r = r["train"][1]
        if not np.isclose(loss_r, float(loss9.detach()), rtol=1e-5, atol=1e-7) or not all(
                np.allclose(grads_r[k], g9[k].cpu().numpy(), rtol=1e-5, atol=1e-7) for k in g9):
            raise AssertionError(f"rank {r['rank']}'s sharded train step differs from the unsharded step")
        log(f"  rank {r['rank']}: render (dp = 2, sp = 1) {r['render_ms'][1]!r} ms, (dp = 1, sp = 2) "
            f"{r['render_ms'][2]!r} ms a frame (both ranks on the card at once); one "
            f"all-reduce of its slice {r['all_reduce_ms'][1]!r} / {r['all_reduce_ms'][2]!r} ms; train step "
            f"(dp = 2) {r['train_ms'][1]!r} ms, loss {loss_r!r} (each the second of two calls) [{card}]")
    a, b = ranks[0]["train"][1], ranks[1]["train"][1]
    if a[0] != b[0] or not all(np.array_equal(a[1][k], b[1][k]) for k in a[1]):
        raise AssertionError("the two ranks' losses or gradients differ")
    launches9 = Counter()
    for r in ranks:
        launches9.update(r["launches"])
    for name in counters:
        main_path_launches[name] += launches9[name]
    required9 = ("esvo_traverse", "shade", "shade_backward", "compact_forward", "shade (unpermute stores)",
                 "shade_backward (src stores)")
    missing = [n for n in required9 if launches9[n] <= 0]
    folded = [n for n in FOLDED if launches9[n]]
    if missing or folded:
        raise AssertionError(f"the ranks never launched {missing}, or launched {folded}")
    log(f"  both layouts equal the unsharded average (rtol and atol 1e-6), the train step's loss and gradients "
        f"the unsharded step's (rtol 1e-5, atol 1e-7) and each other; unsharded loss {float(loss9.detach())!r}; the "
        f"ranks' launches {dict((k, v) for k, v in launches9.items() if v)}; {spawn_s:.1f} s with the spawn")
    del ranks, want, p9, g9, loss9

    # K2q's row counts its three modes' launches
    main_path_launches["esvo_traverse_models"] = sum(main_path_launches[m] for m in model_modes)
    log(f"  K2q launches on the main paths by mode: {[main_path_launches[m] for m in model_modes]}")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=main_path_launches[name], library_ms=None)
        row.update(results[name])
        kernels.append(row)
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:  # stop the host processes main started, whatever happened
        for proc in CHILDREN.values():
            if proc.is_alive():
                proc.terminate()
            proc.join()
    sys.exit(rc)
