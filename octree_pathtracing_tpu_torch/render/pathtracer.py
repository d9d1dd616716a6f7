"""Wavefront path tracer (port of ``render/pathtracer.py``).

Per hit one lobe is chosen (metal / specular / diffuse / refraction /
transmission), with sky and sun on a miss and emission on diffuse hits:
this base shading is kernel K4 (``ops/shade.shade``, forward and backward
on the card).  Diffuse bounces add next-event estimates toward the sun (FAST and
HIGH_QUALITY) and toward emissive blocks (``EmitterSampling`` ONE,
ONE_BLOCK, ALL): K4's next-event half with K6's emitter pick
(``ops/nee.nee``: ``nee_setup``, one shadow walk for every face of the
bounce, ``nee_resolve``; ``nee_backward`` on the card).  The old entry
points of the attenuation (``shadow_attenuation`` and the recompute
helpers) stay here for callers of a single walk.  The recursion is an iterative
bounce loop over a structure-of-arrays lane batch.  The bounce axis of the
uniform block ``(B, n_bounces, 21)`` sets the depth cap.

Before every bounce after the first, kernel K5
(``ops/compact.compact_for_bounce``) stably partitions the lane state, the
live lanes first, carrying each lane's original index and gathering the
bounce's uniforms through it, as the JAX package's
``_sort_state_by_active`` does; every bounce then runs over all B lanes, a
dead lane fetching nothing in the traversal and leaving its state as it is
in the shading.  The last bounce's writer of the radiance (K4 on a scene
that samples no light, ``nee_resolve`` on one that does) is given the
carried index and stores each row's radiance back in the lanes' own order,
and its backward reads the cotangent there: the scatter JAX makes after the
loop (``.at[idx].set``), folded into those stores, so no frame launches
``ops/compact.unpermute``.  With a gradient the
compaction makes no autograd node: the bounce's K4 and next-event half take
the throughput and the radiance from before it as their differentiable
inputs, and their backwards store each row's gradients back where the row
came from (``ops/compact.Lanes``).  Every shape stays the batch's and nothing between the first
bounce and the last reads the card from the host (the live counts stay on
the card until ``trace_paths_census`` reads them once), so a frame can be
captured in a CUDA graph.  The JAX package's TPU scheduling (tiles,
straggler drain, sort schedule, beam) has no counterpart: it never changed
the output.

Traversals: kernel K1 on all-opaque scenes, K2 (the in-loop alpha accept)
on scenes with alpha-holed textures, and its block-model variant K2q on
scenes with models; shadow walks take one K1 / K2 traversal on
``shadow_binary`` scenes (every texel alpha exactly 1, no quad models) and
the stateful walk K3s (K2q's mode 3 with models) otherwise.  A scene's
analytic primitives (K7's scan) compete with the octree hit, the nearer
winning, and attenuate shadow rays by the nearest one's factor: on the card
the bounce's scan runs inside K4's forward and the shadow rays' inside
``nee_setup``; ``models/prims.intersect_prims`` (kernel K7) serves a single
walk (``shadow_attenuation``).  Gradients flow into the atlas texels and the
material table through the shading and through the attenuation, which is
recomputed from the walk's recorded surfaces; the traversals and the
primitive scan are detached.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.prims import intersect_prims
from ..models.scene import MAX_DIST, Scene
from ..ops import nee as nee_mod
from ..ops.compact import compact_for_bounce
from ..ops.nee import nee
from ..ops.random import philox_uniforms
from ..ops.shade import shade, sky_radiance  # noqa: F401 (sky_radiance: this module's name since the port began)
from ..ops.shading import N_UNIFORMS, OFFSET
from ..ops.traversal import HitResult, QuadSurface, traverse, traverse_alpha, traverse_shadow
from .hit import accept_tables

MAX_BOUNCES = 5


def _albedo_at(scene: Scene, mat_id, uv):
    """(B, 4) texel of material ``mat_id`` at ``uv``; differentiable in the
    atlas."""
    return nee_mod._albedo_at(scene, mat_id, uv[:, 0], uv[:, 1])[0]


def _walk_args(scene: Scene, origins, dirs):
    return (scene.nodes, scene.root, scene.depth, scene.octree_scale,
            origins.detach().contiguous(), dirs.detach().contiguous())


def _trace(scene: Scene, origins, dirs, active=None) -> HitResult:
    """First accepted hit of every lane given, detached from autograd: K1 on
    all-opaque scenes, K2 (the in-loop alpha accept) otherwise.  ``active``:
    optional (B,) bool; False lanes fetch nothing and miss."""
    args = _walk_args(scene, origins, dirs)
    if scene.opaque_only:
        return traverse(*args, MAX_DIST, active)
    return traverse_alpha(*args, accept_tables(scene), MAX_DIST, active)


def shadow_attenuation(scene: Scene, origins, dirs, cur_mat, active=None, max_t=None):
    """Direct-light attenuation of the shadow rays ``origins`` + t ``dirs``,
    (B, 4): rgb and the alpha budget w.

    The walk passes through up to K_SURFACES alpha surfaces: per
    surface rgb *= albedo * alpha + (1 - alpha) and w *= 1 - alpha; strict
    mode zeroes w on an IOR change.  One detached traversal records the
    surfaces (kernel K3s); the product is then recomputed differentiably from
    the recorded (mat, uv) rows, so gradients reach the blockers' texels.

    ``max_t``: optional (B,) world distance; surfaces at or beyond it do not
    attenuate (emitter NEE: the light's own face must not shadow itself).
    ``shadow_binary`` scenes (every texel alpha exactly 1): the first surface
    always spends the whole budget, so one first-hit traversal (K1 / K2)
    with the same single-surface recompute gives the same values and
    gradients.  The render path casts these walks through ``ops/nee``."""
    strict = scene.sun_sampling.strict_direct_light
    o_walk = origins + dirs * OFFSET
    if scene.shadow_binary:
        res = _trace(scene, o_walk, dirs, active)
        return _binary_att_from_res(scene, origins, dirs, res, cur_mat, max_t, strict)
    _, st = traverse_shadow(
        *_walk_args(scene, o_walk, dirs), accept_tables(scene), cur_mat.to(torch.int32).contiguous(),
        strict, max_t is not None, MAX_DIST, active,
    )
    return _stateful_att_from_state(scene, o_walk, dirs, cur_mat, st, max_t, strict)


def _stateful_att_from_state(scene: Scene, o_walk, dirs, cur_mat, st, max_t, strict: bool):
    """The differentiable attenuation recompute from a walk's recorded
    surfaces (``ops/traversal.ShadowState``) for lanes whose medium was
    ``cur_mat``; the walk started at ``o_walk`` along ``dirs``."""
    att_rgb, w = nee_mod.stateful_chain(scene, st, cur_mat, max_t, strict)[:2]
    return _shadow_prims(scene, o_walk, dirs, cur_mat, att_rgb, w, max_t, strict)


def _binary_att_from_res(scene: Scene, origins, dirs, res, cur_mat, max_t, strict: bool):
    """The binary walk's attenuation from its first-hit traversal ``res``.
    Its ``t`` is measured from the shifted origin ``origins + dirs * OFFSET``
    and compared with ``max_t`` as it is, as the reference does."""
    att_rgb, w = nee_mod.binary_chain(scene, res, cur_mat, max_t, strict)[:2]
    return _shadow_prims(scene, origins + dirs * OFFSET, dirs, cur_mat, att_rgb, w, max_t, strict)


def _shadow_prims(scene: Scene, o_walk, dirs, cur_mat, att_rgb, w, max_t, strict: bool):
    """Fold the analytic primitives into a shadow attenuation and pack it
    (B, 4): the nearest primitive along the walk (from ``o_walk``, short of
    ``max_t``) contributes one attenuation factor, with the strict-IOR zero;
    a translucent primitive behind another is not walked on to."""
    if scene.prims is None:
        return torch.cat([att_rgb, w[:, None]], -1)
    return nee_mod.prim_fold(scene, _prim_hit(scene, o_walk, dirs), cur_mat, att_rgb, w, max_t, strict)[0]


def _prim_hit(scene: Scene, origins, dirs):
    """The analytic-primitive hit of each lane (kernel K7), detached like
    the traversal: (hit, t, mat, uv (B, 2), normal (B, 3)); gradients flow
    through the albedo gathers downstream."""
    return intersect_prims(scene.prims, origins.detach().contiguous(), dirs.detach().contiguous(), MAX_DIST)


def _init_state(origins, dirs):
    b = origins.shape[0]
    dev = origins.device
    return dict(
        origin=origins.to(torch.float32),
        dir=dirs.to(torch.float32),
        throughput=torch.ones((b, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((b, 3), dtype=torch.float32, device=dev),
        active=torch.ones((b,), dtype=torch.bool, device=dev),
        specular=torch.ones((b,), dtype=torch.bool, device=dev),
        cur_mat=torch.zeros((b,), dtype=torch.int32, device=dev),
    )


def _shade(scene: Scene, st, u, res, is_first: bool, may_scatter: bool, idx=None):
    """Shade one resolved traversal: the base shading (sky on miss, lobe
    scatter and emission on hit) through kernel K4 (``ops/shade.shade``),
    then the sun and emitter NEE on diffuse bounces from its hand-off
    through K4's next-event half (``ops/nee.nee``).  Analytic primitives
    compete with the octree hit, the nearer surface winning: K4 scans them
    itself (it is given no K7 hit).  ``idx`` (a frame's last bounce after a
    compaction, the lanes' carried index): the returned radiance is in the
    lanes' own order, stored so by whichever of the two writes it last (the
    next-event half where the scene samples light, else K4); every other
    field stays in row order."""
    light = idx is not None and nee_mod.samples_light(scene)
    out = shade(scene, st, u, res, None, is_first, may_scatter, None if light else idx)
    return dict(out.state, radiance=nee(scene, st, u, out, idx=idx if light else None))


def _emitter_nee(scene: Scene, st, u, base_on, hitpoint, n, albedo):
    """Emitter NEE of one bounce through the plain versions, (B, 3) before
    the throughput: ONE samples one face point of one spatially picked
    emitter, ONE_BLOCK sums the 3 toward faces of one uniformly picked
    emitter, ALL sums them over every emitter (``ops/nee``)."""
    plan = nee_mod.nee_plan(dataclasses.replace(scene, sun_sampling=dataclasses.replace(
        scene.sun_sampling, sun_sampling=False)))
    rays = nee_mod.nee_setup_reference(scene, plan, st["cur_mat"], u, hitpoint, n, None, base_on)
    walk, prim = nee_mod.nee_walks(scene, plan, rays)
    return nee_mod._nee_terms(scene, plan, rays, walk, prim, albedo, st["cur_mat"], False)[2]


def _bounce(scene: Scene, st, u, is_first: bool, may_scatter: bool, idx=None):
    # the first bounce starts all active; later ones run over the whole
    # batch, and the traversal fetches nothing for a dead lane
    res = _trace(scene, st["origin"], st["dir"], None if is_first else st["active"])
    return _shade(scene, st, u, res, is_first, may_scatter, idx)


def _live_bounces(scene: Scene, st, uniforms, first: int, counts):
    """Bounces ``first..n_bounces-1`` over every lane, each after one K5
    compaction (live lanes first; with a gradient the state carries the
    compaction's ``lanes`` into the bounce); the last one is given the
    compaction's ``idx`` and returns the radiance in the lanes' own order.
    ``counts`` (n_bounces,) int32 on the lanes' device, or None, takes the
    live count entering each of those bounces.  Returns the (B, 3)
    radiance."""
    n_bounces = uniforms.shape[1]
    for bounce in range(first, n_bounces):
        st, u = compact_for_bounce(st, uniforms, bounce, counts)
        idx = st["idx"]
        last = bounce + 1 == n_bounces
        st = dict(_bounce(scene, st, u, False, not last, idx if last else None), idx=idx)
    return st["radiance"]


def _frame(scene: Scene, origins, dirs, uniforms):
    """(radiance (B, 3), the live counts (n_bounces,) int32 on the lanes'
    device, slot 0 unset) of one frame."""
    n_bounces = uniforms.shape[1]
    counts = torch.empty((n_bounces,), dtype=torch.int32, device=origins.device)
    st = _bounce(scene, _init_state(origins, dirs), uniforms[:, 0], True, n_bounces > 1)
    return _live_bounces(scene, st, uniforms, 1, counts), counts


def trace_paths_census(scene: Scene, origins, dirs, uniforms):
    """Trace a lane batch to completion.  Returns (radiance (B, 3),
    live (n_bounces,) int64): ``live[i]`` lanes entered bounce ``i`` active —
    the honest denominator for rays/s.  The counts are read from the card
    once, after the frame."""
    radiance, counts = _frame(scene, origins, dirs, uniforms)
    live = counts.to("cpu", torch.int64)
    live[0] = origins.shape[0]
    return radiance, live


def trace_paths(scene: Scene, origins, dirs, uniforms):
    """Trace a lane batch to completion; returns (B, 3) linear radiance.

    ``uniforms``: (B, n_bounces, N_UNIFORMS) pre-drawn block (slot map in
    ``ops/shading.py``).  Reads nothing from the card."""
    return _frame(scene, origins, dirs, uniforms)[0]


def trace_paths_branched(scene: Scene, origins, dirs, uniforms):
    """First-hit branch replication: trace the primary ray once per lane,
    then run ``K = uniforms.shape[1]`` independent continuations from the
    frozen first hit and average them.

    uniforms: (B, K, n_bounces, N_UNIFORMS).  Equal lane for lane to the
    mean over k of ``trace_paths(..., uniforms[:, k])``."""
    b, k, n_bounces = uniforms.shape[:3]
    res = _trace(scene, origins, dirs)  # the one primary traversal
    res_k = _repeat_lanes(res, k)
    st = _init_state(origins.repeat_interleave(k, dim=0), dirs.repeat_interleave(k, dim=0))
    u = uniforms.reshape(b * k, n_bounces, uniforms.shape[-1])
    st = _shade(scene, st, u[:, 0], res_k, is_first=True, may_scatter=n_bounces > 1)
    return _live_bounces(scene, st, u, 1, None).reshape(b, k, 3).mean(dim=1)


def _repeat_lanes(res: HitResult, k: int) -> HitResult:
    """``res`` with every lane repeated ``k`` times in place."""

    def rep(x):
        return x.repeat_interleave(k, dim=0) if x.dim() else x

    quad = None if res.quad is None else QuadSurface(*(rep(x) for x in res.quad))
    return HitResult(*(rep(x) for x in res[:-1]), quad=quad)


def draw_uniforms(seed: int, counter: int, n_lanes: int, n_bounces: int = MAX_BOUNCES,
                  device="cuda"):
    """The (n_lanes, n_bounces, N_UNIFORMS) uniform block of stream
    ``counter`` under ``seed``, drawn on ``device`` by ``philox_uniforms``
    (kernel P2 on a CUDA device)."""
    n = int(n_lanes) * int(n_bounces) * N_UNIFORMS
    return philox_uniforms(seed, counter, n, device).reshape(n_lanes, n_bounces, N_UNIFORMS)
