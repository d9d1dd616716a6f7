"""Wavefront path tracer (port of ``render/pathtracer.py``).

Per hit one lobe is chosen (metal / specular / diffuse / refraction /
transmission), with sky and sun on a miss and emission on diffuse hits;
diffuse bounces add next-event estimates toward the sun (FAST and
HIGH_QUALITY) and toward emissive blocks (``EmitterSampling`` ONE,
ONE_BLOCK, ALL), each through a shadow walk.  The recursion is an iterative
bounce loop over a structure-of-arrays lane batch.  The bounce axis of the
uniform block ``(B, n_bounces, 21)`` sets the depth cap.

Before every bounce after the first, the live lanes are selected
(``active.nonzero()``) and only they are traversed and shaded; a dead lane's
state is left as it is, which is exactly what the full-batch update does to
it.  The JAX package's TPU scheduling (tiles, straggler drain, sort
schedule, beam) has no counterpart: it never changed the output.

Traversals: kernel K1 on all-opaque scenes, K2 (the in-loop alpha accept)
on scenes with alpha-holed textures; shadow walks take one K1 / K2
traversal on ``shadow_binary`` scenes (every texel alpha exactly 1) and the
stateful walk K3s otherwise.  Gradients flow into the atlas texels and the
material table through the shading and through the attenuation, which is
recomputed from the walk's recorded surfaces; the traversals are detached.
"""

from __future__ import annotations

import math

import torch

from ..models.emitters import ALL_MAX_EMITTERS, sample_emitter_point, toward_face_sample
from ..models.materials import FLAG_REFRACTIVE, FLAG_SUBSURFACE_SCATTER, gather_rows
from ..models.scene import MAX_DIST, EmitterSampling, Scene
from ..models.sun import add_sun_color, add_sun_color_diffuse, random_sun_direction, sky_color
from ..ops.shading import (
    EPSILON,
    N_UNIFORMS,
    OFFSET,
    U_DIFFUSE,
    U_EM1,
    U_EM2,
    U_EM_PICK,
    U_FRESNEL,
    U_METAL,
    U_SPECULAR,
    U_SUBSURFACE,
    U_SUN1,
    U_SUN2,
    diffuse_dir_and_weight,
    fresnel_schlick,
    refract_dir,
    specular_reflect_dir,
)
from ..ops.random import philox_uniforms
from ..ops.texture import sample_atlas
from ..ops.traversal import K_SURFACES, HitResult, traverse, traverse_alpha, traverse_shadow
from .hit import accept_tables, resolve_hit

MAX_BOUNCES = 5


def _albedo_at(scene: Scene, mat_id, uv):
    """(B, 4) texel of material ``mat_id`` at ``uv``; differentiable in the
    atlas."""
    layer = scene.materials.texture_index[mat_id.long()]
    return sample_atlas(scene.atlas, layer, uv[:, 0], uv[:, 1])


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
    gradients."""
    strict = scene.sun_sampling.strict_direct_light
    o_walk = origins + dirs * OFFSET
    if scene.shadow_binary:
        res = _trace(scene, o_walk, dirs, active)
        return _binary_att_from_res(scene, origins, dirs, res, cur_mat, max_t, strict)
    _, st = traverse_shadow(
        *_walk_args(scene, o_walk, dirs), accept_tables(scene), cur_mat.to(torch.int32).contiguous(),
        strict, max_t is not None, MAX_DIST, active,
    )
    return _stateful_att_from_state(scene, cur_mat, st, max_t, strict)


def _stateful_att_from_state(scene: Scene, cur_mat, st, max_t, strict: bool):
    """The differentiable attenuation recompute from a walk's recorded
    surfaces (``ops/traversal.ShadowState``) for lanes whose medium was
    ``cur_mat``."""
    b = cur_mat.shape[0]
    att_rgb = torch.ones((b, 3), dtype=torch.float32, device=cur_mat.device)
    w = torch.ones((b,), dtype=torch.float32, device=cur_mat.device)
    cm = cur_mat
    ior = scene.materials.ior
    for k in range(K_SURFACES):
        mat = st.mats[k]
        albedo = _albedo_at(scene, mat, torch.stack([st.uu[k], st.vv[k]], -1))
        mult = 1.0 - albedo[:, 3]
        new_rgb = att_rgb * (albedo[:, :3] * albedo[:, 3:4] + mult[:, None])
        new_w = w * mult
        if strict:
            new_w = torch.where(ior[cm.long()] != ior[mat.long()], 0.0, new_w)
        upd = (k < st.count) & (w > 0.0)
        if max_t is not None:
            upd = upd & (st.ts[k] < max_t)
        att_rgb = torch.where(upd[:, None], new_rgb, att_rgb)
        w = torch.where(upd, new_w, w)
        cm = torch.where(upd, mat, cm)
    return _shadow_prims(att_rgb, w)


def _binary_att_from_res(scene: Scene, origins, dirs, res, cur_mat, max_t, strict: bool):
    """The binary walk's attenuation from its first-hit traversal ``res``.
    Its ``t`` is measured from the shifted origin ``origins + dirs * OFFSET``
    and compared with ``max_t`` as it is, as the reference does."""
    mat, uv, _, t_hit = resolve_hit(scene, origins + dirs * OFFSET, dirs, res)
    blocked = res.hit
    if max_t is not None:
        blocked = blocked & (t_hit < max_t)
    mrow = gather_rows(scene.materials, mat)
    albedo = sample_atlas(scene.atlas, mrow["texture_index"], uv[:, 0], uv[:, 1])
    mult = 1.0 - albedo[:, 3]
    att_rgb = torch.where(blocked[:, None], albedo[:, :3] * albedo[:, 3:4] + mult[:, None], 1.0)
    w = torch.where(blocked, mult, 1.0)
    if strict:
        ior_change = scene.materials.ior[cur_mat.long()] != mrow["ior"]
        w = torch.where(blocked & ior_change, 0.0, w)
    return _shadow_prims(att_rgb, w)


def _shadow_prims(att_rgb, w):
    """Fold analytic primitives into a shadow attenuation.  A port scene
    carries none (``make_scene`` refuses them), so this only packs (B, 4)."""
    return torch.cat([att_rgb, w[:, None]], -1)


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


def lobe_scatter(scene: Scene, u, d_in, n, albedo, mrow, cur_mat, is_first: bool):
    """Single-lobe scatter decision + outgoing ray for a resolved hit, whose
    material row ``mrow`` comes from ``gather_rows``.  ``is_first``: the
    primary bounce, the only one on which emission found by BSDF sampling
    counts while emitter sampling is on.

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

    # emission on diffuse hits; with emitter sampling on, the lights' direct
    # light comes from NEE after the primary bounce
    emit_when = do_diff
    if not scene.emitters_enabled or (scene.emitter_sampling != EmitterSampling.NONE and not is_first):
        emit_when = torch.zeros_like(do_diff)
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
    """Shade one resolved traversal: sky on miss, lobe scatter on hit, sun and
    emitter NEE on diffuse bounces."""
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

    sc = lobe_scatter(scene, u, st["dir"], n, albedo, mrow, st["cur_mat"], is_first)
    radiance = radiance + torch.where(can_scatter[:, None], st["throughput"] * sc["emit_rgb"], 0.0)

    strat = scene.sun_sampling
    if strat.sun_sampling:  # sun NEE on diffuse bounces
        sun_dir = random_sun_direction(scene.sun, u[:, U_SUN1], u[:, U_SUN2])
        cos_sun = torch.sum(sun_dir * n, dim=-1)
        front = cos_sun > 0.0
        sss = ((mrow["flags"] & FLAG_SUBSURFACE_SCATTER) != 0) & (u[:, U_SUBSURFACE] < scene.f_sub_surface)
        shadow_on = sc["do_diff"] & can_scatter & (front | sss)
        shadow_origin = torch.where(front[:, None], hitpoint, hitpoint - OFFSET * n)
        att = shadow_attenuation(scene, shadow_origin, sun_dir, st["cur_mat"], active=shadow_on)
        lum = scene.sun.luminosity_pdf if strat.sun_luminosity else 1.0
        mult = torch.abs(cos_sun) * lum * att[:, 3]
        nee = albedo[:, :3] * (att[:, :3] * mult[:, None]) * scene.sun.emittance[None, :3]
        radiance = radiance + torch.where(shadow_on[:, None], st["throughput"] * nee, 0.0)

    if scene.emitter_sampling != EmitterSampling.NONE and scene.emitters is not None and scene.emitters_enabled:
        em_contrib = _emitter_nee(scene, st, u, sc["do_diff"] & can_scatter, hitpoint, n, albedo)
        radiance = radiance + st["throughput"] * em_contrib

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


def _emitter_nee(scene: Scene, st, u, base_on, hitpoint, n, albedo):
    """Emitter NEE of one bounce, (B, 3) before the throughput: ONE samples
    one face point of one spatially picked emitter, ONE_BLOCK sums the 3
    toward faces of one uniformly picked emitter, ALL sums them over every
    emitter.  ONE_BLOCK and ALL reuse the (U_EM1, U_EM2) pair for every
    face, as the reference does (unbiased; the face samples correlate)."""
    em = scene.emitters
    # A lane off the diffuse lobe contributes nothing (the masks below), but a
    # miss's hit point lies at infinity and would make its terms NaN; the
    # masks' backward then multiplies 0 by NaN into the atlas and emittance
    # gradients (the reference does so on every scene rays escape from).  A
    # finite stand-in point keeps those terms finite; no value changes.
    hitpoint = torch.where(base_on[:, None], hitpoint, 0.0)
    hp_sg = hitpoint.detach()

    def em_face_contrib(q, ne, mat_e, uv, inv_pdf):
        """Area-form contribution of one sampled emitter point, masked to
        zero off-lobe and on back-facing pairs."""
        to_q = q.detach() - hitpoint
        # sqrt(max(., eps^2)) keeps the backward finite on masked lanes
        # where q == hitpoint
        dist = torch.sqrt(torch.clamp(torch.sum(to_q * to_q, -1), min=EPSILON * EPSILON))
        wi = to_q / dist[:, None]
        cos_s = torch.sum(wi * n, dim=-1)
        cos_e = torch.sum(-wi * ne, dim=-1)
        on = base_on & (cos_s > 0.0) & (cos_e > 0.0)
        # truncate the walk just short of the emitter, so that its own entry
        # face never shadows it
        att = shadow_attenuation(scene, hitpoint, wi, st["cur_mat"], active=on, max_t=dist * (1.0 - 1e-3))
        mrow_e = gather_rows(scene.materials, mat_e)
        albedo_e = sample_atlas(scene.atlas, mrow_e["texture_index"], uv[:, 0], uv[:, 1])
        l_e = albedo_e[:, :3] * albedo_e[:, :3] * mrow_e["emittance"][:, None]
        geom = cos_s * cos_e / torch.clamp(dist * dist, min=EPSILON) / math.pi
        contrib = albedo[:, :3] * l_e * att[:, :3] * (geom * inv_pdf * att[:, 3])[:, None]
        return torch.where(on[:, None], contrib, 0.0)

    if scene.emitter_sampling == EmitterSampling.ONE:
        smp = sample_emitter_point(em, hp_sg, u[:, U_EM_PICK], u[:, U_EM1], u[:, U_EM2], n=n.detach())
        return em_face_contrib(smp["q"], smp["ne"], smp["mat"], smp["uv"], smp["inv_pdf"])
    e_cnt = em.count
    acc = torch.zeros_like(albedo[:, :3])
    if scene.emitter_sampling == EmitterSampling.ONE_BLOCK:
        idx = torch.clamp((u[:, U_EM_PICK] * e_cnt).to(torch.int32), max=e_cnt - 1).long()
        pos_e, size_e, mat_e = em.pos[idx], em.size[idx], em.mat[idx]
        inv_pdf = float(e_cnt) * size_e * size_e
        for axis in range(3):
            q, ne, uv = toward_face_sample(pos_e, size_e, hp_sg, axis, u[:, U_EM1], u[:, U_EM2])
            acc = acc + em_face_contrib(q, ne, mat_e, uv, inv_pdf)
        return acc
    # EmitterSampling.ALL: one step per emitter block
    if e_cnt > ALL_MAX_EMITTERS:
        raise ValueError(
            f"EmitterSampling.ALL sums 3 shadow traversals per "
            f"emitter per diffuse bounce — O(E) work; this scene has "
            f"E={e_cnt} > {ALL_MAX_EMITTERS}.  Use EmitterSampling."
            f"ONE (spatially-selected, O(1) per bounce) for large "
            f"emitter tables."
        )
    b_lanes = hitpoint.shape[0]
    for i in range(e_cnt):
        pos_e = em.pos[i].expand(b_lanes, 3)
        size_e = em.size[i].expand(b_lanes)
        mat_e = em.mat[i].expand(b_lanes)
        inv_pdf = size_e * size_e  # a deterministic block sum: no pick factor
        for axis in range(3):
            q, ne, uv = toward_face_sample(pos_e, size_e, hp_sg, axis, u[:, U_EM1], u[:, U_EM2])
            acc = acc + em_face_contrib(q, ne, mat_e, uv, inv_pdf)
    return acc


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
