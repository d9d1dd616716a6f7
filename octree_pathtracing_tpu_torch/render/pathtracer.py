"""Wavefront path tracer (port of ``render/pathtracer.py``, forward path).

Per hit one lobe is chosen (metal / specular / diffuse / refraction /
transmission), with sky and sun on a miss and emission on diffuse hits;
the recursion is an iterative bounce loop over a structure-of-arrays lane
batch.  The bounce axis of the uniform block ``(B, n_bounces, 21)`` sets
the depth cap.

Before every bounce after the first, the live lanes are selected
(``active.nonzero()``) and only they are traversed and shaded; a dead lane's
state is left as it is, which is exactly what the full-batch update does to
it.  The JAX package's TPU scheduling (tiles, straggler drain, sort
schedule, beam) has no counterpart: it never changed the output.

Covered: all-opaque scenes (kernel K1, no accept in the traversal) and
scenes with alpha-holed textures (kernel K2, the in-loop alpha accept), sun
strategies without shadow rays, no emitter sampling.  Anything else raises
``NotImplementedError`` naming its ROADMAP item.  Gradients flow into the
atlas texels and the material table through the shading; the traversal is
detached.
"""

from __future__ import annotations

import torch

from ..models.materials import FLAG_REFRACTIVE, gather_rows
from ..models.scene import MAX_DIST, EmitterSampling, Scene
from ..models.sun import add_sun_color, add_sun_color_diffuse, sky_color
from ..ops.shading import (
    EPSILON,
    N_UNIFORMS,
    OFFSET,
    U_DIFFUSE,
    U_FRESNEL,
    U_METAL,
    U_SPECULAR,
    diffuse_dir_and_weight,
    fresnel_schlick,
    refract_dir,
    specular_reflect_dir,
)
from ..ops.random import philox_uniforms
from ..ops.texture import sample_atlas
from ..ops.traversal import HitResult, traverse, traverse_alpha
from .hit import accept_tables, resolve_hit

MAX_BOUNCES = 5


def check_supported(scene: Scene):
    """Refuse scene features this port does not implement yet."""
    if scene.sun_sampling.sun_sampling:
        raise NotImplementedError(
            "sun sampling with shadow rays (FAST / HIGH_QUALITY): ROADMAP queue 1, item 5"
        )
    if scene.emitter_sampling != EmitterSampling.NONE:
        raise NotImplementedError("emitter sampling: ROADMAP queue 1, item 6")


def _albedo_at(scene: Scene, mat_id, uv):
    """(B, 4) texel of material ``mat_id`` at ``uv``; differentiable in the
    atlas."""
    layer = scene.materials.texture_index[mat_id.long()]
    return sample_atlas(scene.atlas, layer, uv[:, 0], uv[:, 1])


def _trace(scene: Scene, origins, dirs) -> HitResult:
    """First accepted hit of every lane given, detached from autograd: K1 on
    all-opaque scenes, K2 (the in-loop alpha accept) otherwise."""
    args = (scene.nodes, scene.root, scene.depth, scene.octree_scale,
            origins.detach().contiguous(), dirs.detach().contiguous())
    if scene.opaque_only:
        return traverse(*args, MAX_DIST)
    return traverse_alpha(*args, accept_tables(scene), MAX_DIST)


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


def sky_radiance(scene: Scene, dirs, bounce0_mask, specular_mask):
    """Sky + sun colour for miss rays, (B, 3)."""
    sky = sky_color((dirs.shape[0],), dirs.device)
    sky_specular = add_sun_color(scene.sun, dirs, sky)[:, :3]
    if scene.sun_sampling.diffuse_sun:
        sky_diffuse = add_sun_color_diffuse(scene.sun, dirs, sky)[:, :3]
    else:
        sky_diffuse = sky[:, :3]
    return torch.where((bounce0_mask | specular_mask)[:, None], sky_specular, sky_diffuse)


def lobe_scatter(scene: Scene, u, d_in, n, albedo, mrow, cur_mat):
    """Single-lobe scatter decision + outgoing ray for a resolved hit, whose
    material row ``mrow`` comes from ``gather_rows``.

    Returns a dict: new_dir (B, 3), tp_mult (B, 3) throughput multiplier,
    enters (B,) lane enters the hit material, clears_specular (B,),
    emit_rgb (B, 3) emitted radiance (pre-throughput, lobe-masked), do_diff."""
    m = scene.materials
    alpha = albedo[:, 3]
    metal = mrow["metalness"]
    spec = mrow["specular"]
    emit = mrow["emittance"]
    ior1 = mrow["ior"]
    ior2 = m.ior[cur_mat.long()]

    do_metal = (metal > EPSILON) & (u[:, U_METAL] < metal)
    do_spec = ~do_metal & (spec > EPSILON) & (u[:, U_SPECULAR] < spec)
    do_diff = ~do_metal & ~do_spec & (u[:, U_DIFFUSE] < alpha)
    do_refr = ~do_metal & ~do_spec & ~do_diff & (torch.abs(ior1 - ior2) >= EPSILON)
    do_trans = ~do_metal & ~do_spec & ~do_diff & ~do_refr

    # emission on diffuse hits (EmitterSampling.NONE: no light sampling)
    emit_when = do_diff if scene.emitters_enabled else torch.zeros_like(do_diff)
    emit_cond = emit_when & (emit > EPSILON)
    emit_rgb = torch.where(
        emit_cond[:, None], albedo[:, :3] * albedo[:, :3] * emit[:, None], 0.0
    )

    diff_dir, diff_w = diffuse_dir_and_weight(
        n, scene.sun, u, scene.sun_sampling.importance_sampling
    )
    spec_dir = specular_reflect_dir(d_in, n, mrow["roughness"], u)

    refractive = (mrow["flags"] & FLAG_REFRACTIVE) != 0
    ratio = ior1 / ior2
    cos_theta = -torch.sum(d_in * n, dim=-1)
    radicand = 1.0 - ratio * ratio * (1.0 - cos_theta * cos_theta)
    tir = refractive & (radicand < EPSILON)
    refl_p = fresnel_schlick(ior1, ior2, cos_theta)
    refr_reflect = do_refr & (tir | (u[:, U_FRESNEL] < refl_p))
    refr_refract = do_refr & ~refr_reflect & refractive
    refr_pass = do_refr & ~refr_reflect & ~refractive
    refracted = refract_dir(d_in, n, ratio, cos_theta, radicand)

    new_dir = torch.where((do_metal | do_spec | refr_reflect)[:, None], spec_dir, d_in)
    new_dir = torch.where(do_diff[:, None], diff_dir, new_dir)
    new_dir = torch.where(refr_refract[:, None], refracted, new_dir)

    rgb = albedo[:, :3]
    enters = refr_refract | refr_pass | do_trans
    tp_mult = torch.ones_like(rgb)
    tp_mult = torch.where(do_metal[:, None], rgb, tp_mult)
    tp_mult = torch.where(do_diff[:, None], rgb * diff_w[:, None], tp_mult)
    tp_mult = torch.where(enters[:, None], rgb * alpha[:, None], tp_mult)

    return dict(
        new_dir=new_dir,
        tp_mult=tp_mult,
        enters=enters,
        clears_specular=do_diff,
        emit_rgb=emit_rgb,
        do_diff=do_diff,
    )


def _shade(scene: Scene, st, u, res, is_first: bool, may_scatter: bool):
    """Shade one resolved traversal: sky on miss, lobe scatter on hit."""
    active = st["active"]
    miss = active & ~res.hit
    hit = active & res.hit  # res.hit is already False on inactive lanes
    bounce0 = torch.full_like(active, is_first)

    sky_rgb = sky_radiance(scene, st["dir"], bounce0, st["specular"])
    radiance = st["radiance"] + torch.where(miss[:, None], st["throughput"] * sky_rgb, 0.0)

    # depth cap: the last bounce shades but does not scatter
    can_scatter = hit if may_scatter else torch.zeros_like(hit)

    mat, hit_uv, n, t_hit = resolve_hit(scene, st["origin"], st["dir"], res)
    mrow = gather_rows(scene.materials, mat)
    albedo = sample_atlas(scene.atlas, mrow["texture_index"], hit_uv[:, 0], hit_uv[:, 1])
    hitpoint = st["origin"] + st["dir"] * t_hit[:, None]

    sc = lobe_scatter(scene, u, st["dir"], n, albedo, mrow, st["cur_mat"])
    radiance = radiance + torch.where(can_scatter[:, None], st["throughput"] * sc["emit_rgb"], 0.0)

    new_origin = hitpoint + sc["new_dir"] * OFFSET
    upd = can_scatter
    return dict(
        origin=torch.where(upd[:, None], new_origin, st["origin"]),
        dir=torch.where(upd[:, None], sc["new_dir"], st["dir"]),
        throughput=torch.where(upd[:, None], st["throughput"] * sc["tp_mult"], st["throughput"]),
        radiance=radiance,
        active=can_scatter,
        specular=torch.where(upd & sc["clears_specular"], False, st["specular"]),
        cur_mat=torch.where(upd & sc["enters"], mat, st["cur_mat"]),
    )


def _bounce(scene: Scene, st, u, is_first: bool, may_scatter: bool):
    # every lane of ``st`` is live: the first bounce starts all active, and
    # later bounces see only the lanes ``_live_bounces`` selected
    res = _trace(scene, st["origin"], st["dir"])
    return _shade(scene, st, u, res, is_first, may_scatter)


def _live_bounces(scene: Scene, st, uniforms, first: int):
    """Bounces ``first..n_bounces-1`` over the live lanes only.  Returns the
    final state and the live-lane count entering each of those bounces."""
    n_bounces = uniforms.shape[1]
    live = []
    for bounce in range(first, n_bounces):
        idx = st["active"].nonzero().squeeze(1)
        live.append(int(idx.numel()))
        if live[-1] == 0:
            live += [0] * (n_bounces - bounce - 1)
            break
        sub = _bounce(
            scene,
            {k: v[idx] for k, v in st.items()},
            uniforms[idx, bounce],
            is_first=False,
            may_scatter=bounce + 1 < n_bounces,
        )
        st = {k: v.index_put((idx,), sub[k]) for k, v in st.items()}
    return st, live


def trace_paths_census(scene: Scene, origins, dirs, uniforms):
    """Trace a lane batch to completion.  Returns (radiance (B, 3),
    live (n_bounces,) int64): ``live[i]`` lanes entered bounce ``i`` active —
    the honest denominator for rays/s."""
    check_supported(scene)
    n_bounces = uniforms.shape[1]
    st = _bounce(scene, _init_state(origins, dirs), uniforms[:, 0], True, n_bounces > 1)
    st, live = _live_bounces(scene, st, uniforms, 1)
    return st["radiance"], torch.tensor([origins.shape[0]] + live)


def trace_paths(scene: Scene, origins, dirs, uniforms):
    """Trace a lane batch to completion; returns (B, 3) linear radiance.

    ``uniforms``: (B, n_bounces, N_UNIFORMS) pre-drawn block (slot map in
    ``ops/shading.py``)."""
    return trace_paths_census(scene, origins, dirs, uniforms)[0]


def trace_paths_branched(scene: Scene, origins, dirs, uniforms):
    """First-hit branch replication: trace the primary ray once per lane,
    then run ``K = uniforms.shape[1]`` independent continuations from the
    frozen first hit and average them.

    uniforms: (B, K, n_bounces, N_UNIFORMS).  Equal lane for lane to the
    mean over k of ``trace_paths(..., uniforms[:, k])``."""
    check_supported(scene)
    b, k, n_bounces = uniforms.shape[:3]
    res = _trace(scene, origins, dirs)  # the one primary traversal
    res_k = HitResult(*(x.repeat_interleave(k, dim=0) if x.dim() else x for x in res))
    st = _init_state(origins.repeat_interleave(k, dim=0), dirs.repeat_interleave(k, dim=0))
    u = uniforms.reshape(b * k, n_bounces, uniforms.shape[-1])
    st = _shade(scene, st, u[:, 0], res_k, is_first=True, may_scatter=n_bounces > 1)
    st, _ = _live_bounces(scene, st, u, 1)
    return st["radiance"].reshape(b, k, 3).mean(dim=1)


def draw_uniforms(seed: int, counter: int, n_lanes: int, n_bounces: int = MAX_BOUNCES,
                  device="cuda"):
    """The (n_lanes, n_bounces, N_UNIFORMS) uniform block of stream
    ``counter`` under ``seed``, drawn on ``device`` by ``philox_uniforms``
    (kernel P2 on a CUDA device)."""
    n = int(n_lanes) * int(n_bounces) * N_UNIFORMS
    return philox_uniforms(seed, counter, n, device).reshape(n_lanes, n_bounces, N_UNIFORMS)
