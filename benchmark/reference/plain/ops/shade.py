"""Kernel K4, hit resolve and shade: one bounce's base shading of a lane
batch, forward and backward (port of ``render/pathtracer.py`` ``_shade``
without its next-event estimates, ``lobe_scatter`` and ``sky_radiance``,
``render/hit.resolve_hit`` and the shading pieces they call).

Per lane: the hit's material, uv, normal and t (the leaf's material, a
block model's face material, a quad model's quad, or the nearer analytic
primitive: K7's hit where the caller gives one, else, on a scene with
primitives, the forward's own scan of the lane's ray, K7 folded into the
kernel; a dead lane sees none), the material row and the nearest texel,
the sky and sun on a miss, one lobe's scatter (metal, specular, diffuse with the sun-importance
warp, refraction with Fresnel and total internal reflection, or
transmission), emission, and the masked update of the seven state fields.
Besides the new state it hands the next-event code the lane's albedo, hit
point, normal, material and whether the lane scattered diffusely.

Only the throughput, the radiance and the albedo carry gradient; the
gradient reaches the atlas texel each lane read and the hit material's
emittance.  :func:`shade` launches the forward kernel of
``csrc/shade.cu`` on CUDA tensors, and its backward kernel when the
gradient is taken; on CPU tensors it runs the plain-torch twins
:func:`shade_reference` and :func:`shade_backward_reference`.  There is no
fallback from one to the other.  Where no gradient can be taken (grad mode
off, or none of the throughput, the radiance, the atlas texels and the
emittance requiring grad) :func:`shade` calls the forward alone, without
an autograd node or a residual.  On the card a forward call is one
allocation, carved into every output (:func:`_output_layout`; with a
gradient, what the backward saves is a second), and one
entry-point call with the per-lane pointers in one flat array; a backward
call is one zero-filled allocation for the atlas and emittance gradients
and one entry-point call.

After a compaction (``ops/compact.compact_for_bounce``) the state carries
``lanes``: the differentiable throughput and radiance are then the ones
from before the compaction, and the backward stores each row's gradients
at the row it came from (``lanes.src``), so the compaction's own backward
never runs.  On a frame's last bounce of a scene that samples no light K4
writes the frame's final radiance: given the compaction's ``idx`` it
stores row ``i``'s new radiance at row ``idx[i]`` (the lanes' own order,
the unpermute after the bounce loop folded into the store), and its
backward reads the radiance cotangent at row ``idx[i]``; every other output
stays in row order.

The forward leaves a residual for the backward (24 bytes per lane): the
linear index of the texel read, the hit material and a lane code (miss,
emission on, the lobe that multiplied the throughput), and three floats
(the sky colour on a miss, the diffuse weight on a diffuse bounce); the
backward also reads the albedo and the incoming throughput.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import prims as k7
from ..models.materials import FLAG_REFRACTIVE, gather_rows
from ..models.scene import MAX_DIST, EmitterSampling, Scene, face_normals
from ..models.sun import add_sun_color, add_sun_color_diffuse, sky_color
from . import compact as k5
from .geometry import fma
from .shading import (
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
from .texture import Atlas, sample_atlas, texel_index

# the lane code of the residual: bit 0 a miss, bit 1 emission added, bits
# 2-3 the lobe whose multiplier the throughput took
CODE_MISS, CODE_EMIT = 1, 2
LOBE_SHIFT = 2
LOBE_NONE, LOBE_METAL, LOBE_DIFFUSE, LOBE_ENTERS = 0, 1, 2, 3
STATE_KEYS = ("origin", "dir", "throughput", "radiance", "active", "specular", "cur_mat")
# the material columns and the sun's fields that the forward kernel reads
MATERIAL_FIELDS = ("ior", "specular", "emittance", "roughness", "metalness", "flags", "texture_index")
SUN_FIELDS = ("azimuth", "altitude", "radius", "color", "luminosity", "importance_sample_chance",
              "importance_sample_radius", "sw", "su", "sv", "apparent_texture_brightness")


class Shaded(NamedTuple):
    """One bounce's shading: the new state (``STATE_KEYS``) and the
    hand-off to the next-event code."""

    state: dict  # the seven state fields after the bounce
    albedo: torch.Tensor  # (B, 4) the texel of the hit material at the hit uv
    hitpoint: torch.Tensor  # (B, 3) origin + t dir, rounded once
    normal: torch.Tensor  # (B, 3) the hit's normal
    mat: torch.Tensor  # (B,) int32 the hit's material
    diffuse_on: torch.Tensor  # (B,) bool: the lane scatters diffusely this bounce


class ShadeResidual(NamedTuple):
    """What the backward reads besides the albedo and the incoming
    throughput: ``ints`` (B, 3) int32 (texel index, material, lane code) and
    ``floats`` (B, 3) (the sky colour on a miss; the diffuse weight, 0, 0
    on a diffuse bounce; zeros otherwise)."""

    ints: torch.Tensor
    floats: torch.Tensor


def _leaf_mat(scene: Scene, leaf_value):
    n = scene.leaf_material.shape[0]
    return scene.leaf_material[torch.clamp(leaf_value.long(), 0, n - 1)]


def _leaf_model(scene: Scene, leaf_value):
    lm = scene.models.leaf_model
    return lm[torch.clamp(leaf_value.long(), 0, lm.shape[0] - 1)].long()


def resolve_hit(scene: Scene, origins, dirs, res):
    """Final hit attributes: (mat (B,), uv (B, 2), normal (B, 3), t (B,)).
    A quad-model hit takes the quad's material, uv, normal and t from
    ``res.quad``; any other hit the entry face's."""
    normals = face_normals(res.face_id.device)
    base_normal = normals[torch.clamp(res.face_id.long(), 0, 5)]
    if scene.models is None:
        return _leaf_mat(scene, res.leaf_value), res.uv, base_normal, res.t
    model = _leaf_model(scene, res.leaf_value)
    mat = scene.models.face_material[model, torch.clamp(res.face_id.long(), 0, 5)]
    if not scene.has_quad_models:
        return mat, res.uv, base_normal, res.t
    q = res.quad
    if q is None:
        raise ValueError("resolve_hit: a scene with quad models needs the accepting traversal's quad surfaces")
    use_q = q.found
    return (
        torch.where(use_q, q.mat, mat),
        torch.where(use_q[:, None], q.uv, res.uv),
        torch.where(use_q[:, None], q.normal, base_normal),
        torch.where(use_q, q.t, res.t),
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


def emission_counts(scene: Scene, is_first: bool) -> bool:
    """Whether emission found by BSDF sampling counts on this bounce: with
    emitter sampling on, the lights' direct light comes from NEE after the
    primary bounce."""
    return scene.emitters_enabled and (scene.emitter_sampling == EmitterSampling.NONE or is_first)


def lobe_scatter(scene: Scene, u, d_in, n, albedo, mrow, cur_mat, is_first: bool):
    """Single-lobe scatter decision + outgoing ray for a resolved hit, whose
    material row ``mrow`` comes from ``gather_rows``.  ``is_first``: the
    primary bounce, the only one on which emission found by BSDF sampling
    counts while emitter sampling is on.

    Returns a dict: new_dir (B, 3), tp_mult (B, 3) throughput multiplier,
    enters (B,) lane enters the hit material, clears_specular (B,),
    emit_rgb (B, 3) emitted radiance (pre-throughput, lobe-masked), do_diff,
    do_metal, diff_w (B,) the diffuse lobe's weight."""
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

    emit_when = do_diff if emission_counts(scene, is_first) else torch.zeros_like(do_diff)
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
        do_metal=do_metal,
        diff_w=diff_w,
        emit_cond=emit_cond,
    )


def scan_prims_reference(scene: Scene, st: dict):
    """Plain version of the primitive scan folded into the forward kernel:
    K7's twin (``models/prims.intersect_prims_reference``) on the lanes'
    rays, detached, a dead lane seeing no primitive (as the traversal gives
    it no hit).  Returns (hit, t, mat, uv, normal)."""
    hit, t, mat, uv, n = k7.intersect_prims_reference(scene.prims, st["origin"].detach(), st["dir"].detach(),
                                                      MAX_DIST)
    return hit & st["active"], t, mat, uv, n


def shade_reference(scene: Scene, st: dict, u, res, prim, is_first: bool, may_scatter: bool, idx=None):
    """Plain-torch twin of the forward kernel (any device): the base shading
    of one bounce.  ``st`` holds ``STATE_KEYS``; ``u`` is (B, N_UNIFORMS);
    ``res`` the traversal's ``HitResult`` (with ``quad`` on a scene with
    quad models); ``prim`` K7's (hit, t, mat, uv, normal), or None: on a
    scene with primitives, :func:`scan_prims_reference` of the lanes.
    ``idx`` ((B,) int32, a frame's last bounce): the new radiance's row
    ``i`` at row ``idx[i]`` (``ops/compact.unpermute_reference``), the other
    outputs in row order.

    Returns (:class:`Shaded`, :class:`ShadeResidual`)."""
    if prim is None and scene.prims is not None:
        prim = scan_prims_reference(scene, st)
    active = st["active"]
    any_hit = res.hit if prim is None else res.hit | prim[0]
    miss = active & ~any_hit
    hit = active & any_hit  # res.hit is already False on inactive lanes
    bounce0 = torch.full_like(active, is_first)

    sky_rgb = sky_radiance(scene, st["dir"], bounce0, st["specular"])
    radiance = st["radiance"] + torch.where(miss[:, None], st["throughput"] * sky_rgb, 0.0)

    # depth cap: the last bounce shades but does not scatter
    can_scatter = hit if may_scatter else torch.zeros_like(hit)

    mat, hit_uv, n, t_hit = resolve_hit(scene, st["origin"], st["dir"], res)
    if prim is not None:  # analytic primitives compete with the octree hit; the nearer wins
        p_hit, p_t, p_mat, p_uv, p_n = prim
        use_p = p_hit & (p_t < torch.where(res.hit, t_hit, float("inf")))
        mat = torch.where(use_p, p_mat, mat)
        hit_uv = torch.where(use_p[:, None], p_uv, hit_uv)
        n = torch.where(use_p[:, None], p_n, n)
        t_hit = torch.where(use_p, p_t, t_hit)
    mrow = gather_rows(scene.materials, mat)
    albedo = sample_atlas(scene.atlas, mrow["texture_index"], hit_uv[:, 0], hit_uv[:, 1])
    hitpoint = fma(st["dir"], t_hit[:, None], st["origin"])  # one rounding, as the reference's

    sc = lobe_scatter(scene, u, st["dir"], n, albedo, mrow, st["cur_mat"], is_first)
    radiance = radiance + torch.where(can_scatter[:, None], st["throughput"] * sc["emit_rgb"], 0.0)

    new_origin = hitpoint + sc["new_dir"] * OFFSET
    upd = can_scatter
    state = dict(
        origin=torch.where(upd[:, None], new_origin, st["origin"]),
        dir=torch.where(upd[:, None], sc["new_dir"], st["dir"]),
        throughput=torch.where(upd[:, None], st["throughput"] * sc["tp_mult"], st["throughput"]),
        radiance=radiance,
        active=can_scatter,
        specular=torch.where(upd & sc["clears_specular"], False, st["specular"]),
        cur_mat=torch.where(upd & sc["enters"], mat, st["cur_mat"]),
    )
    if idx is not None:
        state["radiance"] = k5.unpermute_reference(radiance, idx)
    out = Shaded(state, albedo, hitpoint, n, mat.to(torch.int32), sc["do_diff"] & can_scatter)

    lobe = torch.where(sc["do_metal"], LOBE_METAL,
                       torch.where(sc["do_diff"], LOBE_DIFFUSE, torch.where(sc["enters"], LOBE_ENTERS, LOBE_NONE)))
    code = (miss.int() * CODE_MISS + (can_scatter & sc["emit_cond"]).int() * CODE_EMIT
            + torch.where(upd, lobe, LOBE_NONE).int() * (1 << LOBE_SHIFT))
    texel = texel_index(scene.atlas, mrow["texture_index"], hit_uv[:, 0], hit_uv[:, 1])
    zero = torch.zeros_like(sc["diff_w"])
    diff_w = torch.where(upd & sc["do_diff"], sc["diff_w"], zero)
    floats = torch.where(miss[:, None], sky_rgb, torch.stack([diff_w, zero, zero], -1))
    resid = ShadeResidual(torch.stack([texel.int(), mat.int(), code], -1), floats)
    return out, resid


def shade_backward_reference(albedo, throughput, resid: ShadeResidual, emittance, atlas_shape,
                             g_throughput, g_radiance, g_albedo, need=(True, True, True, True), idx=None):
    """Plain-torch twin of the backward kernel (any device): the gradients
    of one bounce's base shading, from the cotangents of the new throughput,
    the new radiance and the hand-off albedo (each None for zero), written
    out as formulas.  ``albedo`` and ``throughput`` are the forward's albedo
    and incoming throughput, ``resid`` its residual.  ``need``: which of
    (throughput, radiance, atlas, emittance) to return (None otherwise).
    ``idx``: the forward's (a frame's last bounce), whose radiance cotangent
    row ``i`` is read at row ``idx[i]``
    (``ops/compact.unpermute_backward_reference``).

    Returns (d throughput (B, 3), d radiance (B, 3), d atlas ``atlas_shape``,
    d emittance (M,)): the atlas gradient scatter-added into the texel each
    lane read, the emittance gradient into the lane's material."""
    if idx is not None and g_radiance is not None:
        g_radiance = k5.unpermute_backward_reference(g_radiance, idx)
    texel, mat, code = resid.ints.long().unbind(-1)
    miss = (code & CODE_MISS) != 0
    emit_on = (code & CODE_EMIT) != 0
    lobe = code >> LOBE_SHIFT
    rgb, alpha = albedo[:, :3], albedo[:, 3:4]
    e = emittance[mat][:, None]
    diff_w = resid.floats[:, :1]
    d_tp = torch.zeros_like(throughput)
    d_alb = torch.zeros_like(albedo) if g_albedo is None else g_albedo.clone()
    d_emit = torch.zeros_like(e[:, 0])
    if g_radiance is not None:
        d_tp = d_tp + torch.where(miss[:, None], g_radiance * resid.floats, 0.0)
        d_tp = d_tp + g_radiance * torch.where(emit_on[:, None], rgb * rgb * e, 0.0)
        g_emit = torch.where(emit_on[:, None], g_radiance * throughput, 0.0)  # d (rgb^2 e)
        d_alb[:, :3] += 2.0 * (g_emit * e) * rgb
        d_emit = torch.sum(g_emit * (rgb * rgb), -1)
    if g_throughput is not None:
        mult = torch.where((lobe == LOBE_METAL)[:, None], rgb, 1.0)
        mult = torch.where((lobe == LOBE_DIFFUSE)[:, None], rgb * diff_w, mult)
        mult = torch.where((lobe == LOBE_ENTERS)[:, None], rgb * alpha, mult)
        d_tp = d_tp + g_throughput * mult
        g_mult = g_throughput * throughput  # d tp_mult
        d_alb[:, :3] += torch.where((lobe == LOBE_METAL)[:, None], g_mult, 0.0)
        d_alb[:, :3] += torch.where((lobe == LOBE_DIFFUSE)[:, None], g_mult * diff_w, 0.0)
        d_alb[:, :3] += torch.where((lobe == LOBE_ENTERS)[:, None], g_mult * alpha, 0.0)
        d_alb[:, 3] += torch.where(lobe == LOBE_ENTERS, torch.sum(g_mult * rgb, -1), 0.0)
    d_atlas = d_emittance = None
    if need[2]:
        n_texels = atlas_shape[0] * atlas_shape[1] * atlas_shape[2]
        d_atlas = torch.zeros((n_texels, 4), dtype=albedo.dtype, device=albedo.device)
        d_atlas.index_put_((texel,), d_alb, accumulate=True)
        d_atlas = d_atlas.view(atlas_shape)
    if need[3]:
        d_emittance = torch.zeros_like(emittance).index_put_((mat,), d_emit, accumulate=True)
    return (d_tp if need[0] else None, g_radiance if need[1] else None, d_atlas, d_emittance)


def _atlas_data(atlas):
    return atlas.data if isinstance(atlas, Atlas) else atlas


