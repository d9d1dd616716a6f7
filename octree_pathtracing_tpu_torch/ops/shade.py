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

import ctypes
import functools
from typing import NamedTuple

import torch

from ..models import prims as k7
from ..models.materials import FLAG_REFRACTIVE, gather_rows
from ..models.scene import MAX_DIST, EmitterSampling, Scene, face_normals
from ..models.sun import add_sun_color, add_sun_color_diffuse, sky_color
from ..utils.cuda_build import on_current_stream
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


class _Call(NamedTuple):
    """One shading call's arguments other than the four that carry
    gradient."""

    scene: Scene
    st: dict
    u: torch.Tensor
    res: object  # HitResult
    prim: tuple | None
    is_first: bool
    may_scatter: bool
    idx: torch.Tensor | None = None  # a frame's last bounce: the new radiance's row i at row idx[i]


class ShadeFunction(torch.autograd.Function):
    """K4 as an autograd function of (throughput, radiance, atlas texels,
    emittance), the rest of the call in ``call``.  Returns the new state's
    seven fields (``STATE_KEYS``' order) and the hand-off (albedo, hit
    point, normal, material, diffuse mask); only the throughput, the
    radiance and the albedo are differentiable.  CUDA tensors run the
    kernels of ``csrc/shade.cu``, CPU tensors the twins.  Where the state
    carries ``lanes`` (``ops/compact.Lanes``) the throughput and the
    radiance given are those from before the compaction, the kernels read
    the state's compacted rows, and the backward stores each row's
    gradients at the lane it came from (``lanes.src``).  Where the call
    gives ``idx`` (a frame's last bounce) the new radiance is in the lanes'
    own order, and so is its cotangent."""

    @staticmethod
    def forward(ctx, throughput, radiance, atlas, emittance, call: _Call):
        want_grad = any(ctx.needs_input_grad[:4])
        cuda = _uses_kernels(throughput)
        if cuda:
            out, resid = _forward_cuda(call, want_grad)
        else:
            out, resid = shade_reference(*call)
        outputs = tuple(out.state[k] for k in STATE_KEYS) + tuple(out[1:])
        ctx.mark_non_differentiable(*(x for i, x in enumerate(outputs) if i not in (2, 3, 7)))
        ctx.set_materialize_grads(False)
        if want_grad:
            lanes = call.st.get("lanes")
            # the rows the kernel read: the compacted ones where the state was compacted
            ctx.save_for_backward(out.albedo, call.st["throughput"], resid.ints, resid.floats, emittance,
                                  None if lanes is None else lanes.src, call.idx)
            ctx.atlas_shape = tuple(atlas.shape)
        return outputs

    @staticmethod
    def backward(ctx, *grads):
        albedo, throughput, ints, floats, emittance, src, idx = ctx.saved_tensors
        g_tp, g_rad, g_alb = grads[2], grads[3], grads[7]
        need = ctx.needs_input_grad[:4]
        resid = ShadeResidual(ints, floats)
        args = (albedo, throughput, resid, emittance, ctx.atlas_shape, g_tp, g_rad, g_alb, need)
        if _uses_kernels(albedo):
            d = _backward_cuda(*args, **_folds(src, idx))
        else:
            d = shade_backward_reference(*args, idx=idx)
            if src is not None:  # each row's gradients back at the lane it came from, as the kernel stores them
                d = (*k5.store_at_src_reference(src, d[0], d[1]), *d[2:])
        return (*d, None)


def _folds(src, idx) -> dict:
    """The backward's keyword arguments for what the forward folded in: a
    compaction's ``src`` and the final bounce's ``idx``, each where given."""
    return {k: v for k, v in (("src", src), ("idx", idx)) if v is not None}


def _uses_kernels(x) -> bool:
    """Whether ``x``'s device runs K4's kernels (a CUDA tensor) rather than
    the twins (a CPU tensor)."""
    return x.is_cuda


def _atlas_data(atlas):
    return atlas.data if isinstance(atlas, Atlas) else atlas


def _check_no_other_grad(scene: Scene, st: dict, u, res, prim):
    """Raise where a tensor other than the throughput, the radiance, the
    atlas texels and the emittance requires grad: K4 has no gradient for
    it, and nothing may be dropped silently.  One pass over the scene's
    material and sun columns and the call's tensors; the names are built
    only to raise.  (``requires_grad`` can be set in place, so this runs on
    every call that may record a gradient.)"""
    m, sun = scene.materials, scene.sun
    scene_tensors = (m.ior, m.specular, m.roughness, m.metalness, *(getattr(sun, f) for f in SUN_FIELDS))
    per_call = (st["origin"], st["dir"], u, res.t, res.uv)
    if res.quad is not None:
        per_call += (res.quad.uv, res.quad.normal, res.quad.t)
    if prim is not None:
        per_call += (prim[1], prim[3], prim[4])
    if not any(x.requires_grad for x in scene_tensors + per_call):
        return
    names = [f"materials.{f}" for f in ("ior", "specular", "roughness", "metalness")]
    names += [f"sun.{f}" for f in SUN_FIELDS]
    names += ["state.origin", "state.dir", "uniforms", "hit.t", "hit.uv"]
    if res.quad is not None:
        names += ["quad.uv", "quad.normal", "quad.t"]
    if prim is not None:
        names += ["primitive.t", "primitive.uv", "primitive.normal"]
    bad = [name for name, x in zip(names, scene_tensors + per_call) if x.requires_grad]
    raise ValueError(f"shade: K4 differentiates only the throughput, radiance, atlas and emittance; "
                     f"{bad} require grad")


def shade(scene: Scene, st: dict, u, res, prim, is_first: bool, may_scatter: bool, idx=None) -> Shaded:
    """One bounce's base shading (see the module's text).  CUDA tensors
    launch the forward kernel, counted in ``shade.launches`` (and in
    ``shade.scan_launches`` where it scans the primitives), and the
    backward kernel when the gradient is taken, counted in
    ``shade.backward_launches`` (and in ``shade.src_backward_launches``
    where it stores through a compaction's ``src``); CPU tensors run
    :func:`shade_reference` and :func:`shade_backward_reference`.  ``prim``: K7's hit, or None: on
    a scene with primitives the forward scans them itself (on the card the
    kernel's variant with K7 folded in, on the CPU
    :func:`scan_prims_reference`).  Where a gradient may be taken (grad
    mode on and one of the throughput, the radiance, the atlas texels and
    the emittance requiring grad; the throughput and the radiance of
    ``st["lanes"]`` where the state carries it) the call goes through
    :class:`ShadeFunction`; otherwise it launches the forward alone, with
    no autograd node and no residual.  Both give the same outputs bit for
    bit.  ``idx`` ((B,) int32, the compaction's carried lane index; a frame's
    last bounce on a scene that samples no light): the new radiance is
    returned in the lanes' own order, row ``i``'s at row ``idx[i]``
    (counted in ``shade.idx_launches`` and, for the backward, in
    ``shade.idx_backward_launches``).  Any other device raises, and so does
    a tensor other than those four that requires grad while grad mode is
    on."""
    tp = st["throughput"]
    dev = tp.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"shade: unsupported device {dev}")
    if torch.is_grad_enabled():
        atlas, emittance = _atlas_data(scene.atlas), scene.materials.emittance
        _check_no_other_grad(scene, st, u, res, prim)
        lanes = st.get("lanes")
        tp_in, rad_in = (tp, st["radiance"]) if lanes is None else (lanes.throughput, lanes.radiance)
        if tp_in.requires_grad or rad_in.requires_grad or atlas.requires_grad or emittance.requires_grad:
            out = ShadeFunction.apply(tp_in, rad_in, atlas, emittance,
                                      _Call(scene, st, u, res, prim, bool(is_first), bool(may_scatter), idx))
            return Shaded(dict(zip(STATE_KEYS, out[:7])), *out[7:])
    if _uses_kernels(tp):
        return _forward_cuda((scene, st, u, res, prim, bool(is_first), bool(may_scatter), idx), False)[0]
    return shade_reference(scene, st, u, res, prim, bool(is_first), bool(may_scatter), idx)[0]


shade.launches = 0
shade.backward_launches = 0
shade.scan_launches = 0  # of shade.launches: the variant with K7's scan folded in
shade.src_backward_launches = 0  # of shade.backward_launches: storing through a compaction's src
shade.idx_launches = 0  # of shade.launches: storing the radiance at idx (the unpermute folded in)
shade.idx_backward_launches = 0  # of shade.backward_launches: reading the radiance cotangent at idx


# ---- the CUDA kernels

class _SunParams(ctypes.Structure):
    """``struct SunParams`` of ``csrc/shade.cu``."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("azimuth", "altitude", "radius", "color", "luminosity",
                                                "chance", "sample_radius", "sw", "su", "sv", "apparent")]


class _Tables(ctypes.Structure):
    """``struct ShadeTables`` of ``csrc/shade.cu``."""

    _fields_ = [("leaf_material", ctypes.c_void_p), ("n_leaf", ctypes.c_int),
                ("leaf_model", ctypes.c_void_p), ("n_leaf_model", ctypes.c_int),
                ("face_material", ctypes.c_void_p),
                ("ior", ctypes.c_void_p), ("specular", ctypes.c_void_p), ("emittance", ctypes.c_void_p),
                ("roughness", ctypes.c_void_p), ("metalness", ctypes.c_void_p), ("flags", ctypes.c_void_p),
                ("texture_index", ctypes.c_void_p), ("n_mat", ctypes.c_int),
                ("atlas", ctypes.c_void_p), ("sizes", ctypes.c_void_p),
                ("n_layers", ctypes.c_int), ("atlas_h", ctypes.c_int), ("atlas_w", ctypes.c_int),
                ("sun", _SunParams), ("prims", k7._PrimTables), ("prim_t_max", ctypes.c_float)]


class _Flags(ctypes.Structure):
    """``struct ShadeFlags`` of ``csrc/shade.cu``."""

    _fields_ = [(f, ctypes.c_int) for f in ("is_first", "may_scatter", "importance", "diffuse_sun",
                                            "draw_texture", "emission", "scan")]


# The forward's flat slot array (``enum LaneSlot`` of ``csrc/shade.cu``):
# the inputs' pointers, the four state rows' and the uniforms' row strides,
# the outputs' pointers.
IN_SLOTS = ("origin", "dir", "throughput", "radiance", "active", "specular", "cur_mat", "u",
            "hit", "t", "face_id", "uv", "leaf_value",
            "q_found", "q_mat", "q_uv", "q_normal", "q_t", "p_hit", "p_t", "p_mat", "p_uv", "p_normal", "idx")
STRIDE_SLOTS = ("origin_stride", "dir_stride", "throughput_stride", "radiance_stride", "u_stride")
OUT_SLOTS = STATE_KEYS + ("albedo", "hitpoint", "normal", "mat", "diffuse_on", "resid_i", "resid_f")
N_LANE_SLOTS = len(IN_SLOTS) + len(STRIDE_SLOTS) + len(OUT_SLOTS)
# the backward's slot array (``enum BackwardSlot``)
BACKWARD_SLOTS = ("g_throughput", "g_radiance", "g_albedo", "albedo", "throughput", "resid_i", "resid_f",
                  "emittance", "d_throughput", "d_atlas", "d_emittance", "src", "d_radiance", "idx")
LANE_ARRAY = ctypes.c_void_p * N_LANE_SLOTS
BACKWARD_ARRAY = ctypes.c_void_p * len(BACKWARD_SLOTS)


@functools.cache
def _library():
    """K4's shared library (the forward and backward kernels), built at
    first use."""
    from ..utils.cuda_build import load_library

    # no FMA contraction: the twin's eager torch rounds every multiply and add
    lib = load_library("shade", ("-fmad=false",))
    vp, ci, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.shade_forward.argtypes = [ci, vp, vp, vp, ci, vp]  # b, tables, flags, slots, slot count, stream
    lib.shade_forward.restype = ci
    lib.shade_forward_config.argtypes = [ci, ctypes.POINTER(_Tables), ci, pi]
    lib.shade_forward_config.restype = ci
    lib.shade_backward.argtypes = [ci, vp, ci, vp]  # b, slots, slot count, stream
    lib.shade_backward.restype = ci
    lib.shade_backward_config.argtypes = [ci, pi]
    lib.shade_backward_config.restype = ci
    lib.shade_error_string.argtypes = [ci]
    lib.shade_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _rows(x, b: int, k: int, dtype, name: str, who: str = "shade"):
    """``x`` as (B, k) rows of ``dtype`` whose last axis is dense: the kernel
    reads row ``i`` at ``i * stride``.  ``who`` names the wrapper in the
    error."""
    if x.dtype != dtype or x.shape != (b, k):
        raise ValueError(f"{who}: {name} must be ({b}, {k}) {dtype}")
    return x if x.stride(-1) == 1 else x.contiguous()


def _dense(x, shape, dtype, name: str, who: str = "shade"):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{who}: {name} must be a contiguous {tuple(shape)} {dtype}")
    return x


class _SceneEntry(NamedTuple):
    """A scene's tables checked and packed once for all its bounces."""

    tensors: tuple  # the table tensors (the cache's key, by identity)
    device: torch.device
    tables: _Tables
    tables_ref: object  # ctypes.byref(tables)
    flags: dict  # (is_first, may_scatter, importance, diffuse_sun, draw_texture, emission, scan) -> byref(_Flags)
    prims: bool  # the scene has primitives: a call given no K7 hit scans them


# the newest scenes' entries, the newest last
_TABLE_CACHE: list = []
_TABLE_CACHE_SIZE = 4


def _table_tensors(scene: Scene) -> tuple:
    """Every table of ``scene`` that the forward kernel reads (None where
    the scene has none)."""
    mod, atlas, m, sun = scene.models, scene.atlas, scene.materials, scene.sun
    return (_atlas_data(atlas), atlas.sizes if isinstance(atlas, Atlas) else None, scene.leaf_material,
            None if mod is None else mod.leaf_model, None if mod is None else mod.face_material,
            m.ior, m.specular, m.emittance, m.roughness, m.metalness, m.flags, m.texture_index,
            sun.azimuth, sun.altitude, sun.radius, sun.color, sun.luminosity, sun.importance_sample_chance,
            sun.importance_sample_radius, sun.sw, sun.su, sun.sv, sun.apparent_texture_brightness,
            *k7.prim_tensors(scene.prims))


def _scene_entry(scene: Scene) -> _SceneEntry:
    """``scene``'s :class:`_SceneEntry`.  The cache is keyed by the identity
    of the table tensors and holds them, so no key outlives its tensors."""
    key = _table_tensors(scene)
    for entry in reversed(_TABLE_CACHE):
        if all(a is b for a, b in zip(entry.tensors, key)):
            return entry
    data, sizes, leaf_material, leaf_model, face_material = key[:5]
    cols = key[5:5 + len(MATERIAL_FIELDS)]
    f32, i32 = torch.float32, torch.int32
    if data.dtype != f32 or data.dim() != 4 or data.shape[3] != 4 or not data.is_contiguous():
        raise ValueError("shade: the atlas must be a contiguous (T, H, W, 4) float32")
    if data.numel() // 4 >= 2**31:
        raise ValueError("shade: too many texels for one launch")
    if sizes is not None:
        _dense(sizes, (data.shape[0], 2), i32, "the atlas sizes")
    n_mat = cols[0].shape[0]
    for f, x in zip(MATERIAL_FIELDS, cols):
        _dense(x, (n_mat,), i32 if f in ("flags", "texture_index") else f32, f"materials.{f}")
    _dense(leaf_material, (leaf_material.shape[0],), i32, "leaf_material")
    if leaf_model is not None:
        _dense(leaf_model, (leaf_model.shape[0],), i32, "models.leaf_model")
        _dense(face_material, (face_material.shape[0], 6), i32, "models.face_material")
    for f in SUN_FIELDS:
        x = getattr(scene.sun, f)
        if x.dtype != f32 or not x.is_contiguous():
            raise ValueError(f"shade: sun.{f} must be a contiguous float32")
    dev = data.device
    if any(x is not None and x.device != dev for x in key):
        raise ValueError("shade: every input must be on the lanes' card")
    if scene.prims is not None:
        k7.check_tables(scene.prims, dev, "shade")
    sun_end = 5 + len(MATERIAL_FIELDS) + len(SUN_FIELDS)
    tables = _Tables(
        leaf_material.data_ptr(), leaf_material.shape[0],
        _ptr(leaf_model), 0 if leaf_model is None else leaf_model.shape[0], _ptr(face_material),
        *(x.data_ptr() for x in cols), n_mat, data.data_ptr(), _ptr(sizes), data.shape[0], data.shape[1],
        data.shape[2], _SunParams(*(x.data_ptr() for x in key[5 + len(MATERIAL_FIELDS):sun_end])),
        k7.prim_tables(scene.prims), MAX_DIST,
    )
    entry = _SceneEntry(key, dev, tables, ctypes.byref(tables), {}, k7.prim_count(scene.prims) > 0)
    _TABLE_CACHE.append(entry)
    del _TABLE_CACHE[:-_TABLE_CACHE_SIZE]
    return entry


def _flags(entry: _SceneEntry, scene: Scene, is_first: bool, may_scatter: bool, scan: bool):
    """``byref`` of the call's :class:`_Flags`, cached in the scene's entry."""
    strat = scene.sun_sampling
    key = (is_first, may_scatter, strat.importance_sampling, strat.diffuse_sun, scene.sun.draw_texture,
           emission_counts(scene, is_first), scan)
    ref = entry.flags.get(key)
    if ref is None:
        ref = entry.flags[key] = ctypes.byref(_Flags(*(int(x) for x in key)))
    return ref


@functools.lru_cache(maxsize=256)
def _output_layout(b: int, want_grad: bool) -> tuple:
    """((bytes of each buffer), ((offset in the output's dtype, shape,
    stride, dtype index, byte offset, buffer), ...) in ``OUT_SLOTS``'
    order): the forward's outputs carved from one buffer of ``b`` lanes,
    each starting on a 16-byte boundary (the kernel stores the albedo as
    16-byte vectors).  With a gradient, what the backward saves (the albedo
    and the residual) is carved from a second buffer of its own, so that
    saving it keeps nothing else of the bounce alive.  Dtype index 0
    float32, 1 int32, 2 bool."""
    # (B, k) float32 rows, int32 columns, bool columns; the residual last
    spec = {"origin": (3, 0), "dir": (3, 0), "throughput": (3, 0), "radiance": (3, 0), "active": (1, 2),
            "specular": (1, 2), "cur_mat": (1, 1), "albedo": (4, 0), "hitpoint": (3, 0), "normal": (3, 0),
            "mat": (1, 1), "diffuse_on": (1, 2), "resid_i": (3, 1), "resid_f": (3, 0)}
    item = (4, 4, 1)
    saved = ("albedo", "resid_i", "resid_f") if want_grad else ()
    order = sorted(OUT_SLOTS[:-2], key=lambda k: (spec[k][1] == 2, -spec[k][0])) + (
        ["resid_i", "resid_f"] if want_grad else [])
    offsets, ends = {}, [0, 0]
    for k in order:
        buf = int(k in saved)
        offsets[k] = (buf, ends[buf])
        ends[buf] = (ends[buf] + b * spec[k][0] * item[spec[k][1]] + 15) // 16 * 16
    views = []
    for k in OUT_SLOTS:
        if k not in offsets:
            views.append(None)
            continue
        width, kind = spec[k]
        buf, off = offsets[k]
        shape, stride = ((b, width), (width, 1)) if width > 1 else ((b,), (1,))
        views.append((off // item[kind], shape, stride, kind, off, buf))
    sizes = (max(ends[0], 16),) + ((max(ends[1], 16),) if want_grad else ())
    return sizes, tuple(views)


def _carve(b: int, want_grad: bool, dev):
    """The forward's outputs as views of one new buffer, or two with a
    gradient: (the tensors in ``OUT_SLOTS``' order, None for an absent
    residual; their addresses)."""
    sizes, views = _output_layout(b, want_grad)
    bufs = [torch.empty(n, dtype=torch.uint8, device=dev) for n in sizes]
    typed = [(x.view(torch.float32), x.view(torch.int32), x.view(torch.bool)) for x in bufs]
    bases = [x.data_ptr() for x in bufs]
    outs = [None if v is None else typed[v[5]][v[3]].as_strided(v[1], v[2], v[0]) for v in views]
    return outs, [None if v is None else bases[v[5]] + v[4] for v in views]


def _lane_inputs(scene: Scene, st: dict, u, res, prim, idx=None) -> tuple:
    """The forward's inputs in ``IN_SLOTS``' order (None where the scene
    has no quad models, the call no primitives or no ``idx``)."""
    if scene.has_quad_models:
        q = res.quad
        if q is None:
            raise ValueError("shade: a scene with quad models needs the accepting traversal's quad surfaces")
        quad = (q.found, q.mat, q.uv, q.normal, q.t)
    else:
        quad = (None,) * 5
    return (st["origin"], st["dir"], st["throughput"], st["radiance"], st["active"], st["specular"],
            st["cur_mat"], u, res.hit, res.t, res.face_id, res.uv, res.leaf_value, *quad,
            *((None,) * 5 if prim is None else prim), idx)


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
# each input slot's (dtype, width: 0 for (B,), k for (B, k), -k for rows of k with any row stride)
_IN_SPEC = ((_F32, -3), (_F32, -3), (_F32, -3), (_F32, -3), (_BOOL, 0), (_BOOL, 0), (_I32, 0), (_F32, -N_UNIFORMS),
            (_BOOL, 0), (_F32, 0), (_I32, 0), (_F32, 2), (_I32, 0),
            (_BOOL, 0), (_I32, 0), (_F32, 2), (_F32, 3), (_F32, 0),
            (_BOOL, 0), (_F32, 0), (_I32, 0), (_F32, 2), (_F32, 3), (_I32, 0))


@functools.lru_cache(maxsize=256)
def _expected_inputs(b: int, present: tuple) -> tuple:
    """The (dtype, shape) of every present input slot for ``b`` lanes."""
    return tuple((dt, torch.Size((b,) if w == 0 else (b, abs(w))))
                 for (dt, w), here in zip(_IN_SPEC, present) if here)


def _checked_inputs(ins: tuple, b: int, dev):
    """``ins`` checked in one pass (dtype, shape, a dense last axis, dense
    1-D and (B, 2|3) columns, the lanes' card); a row input whose last axis
    is strided is copied dense.  A wrong input raises naming it."""
    present = tuple(x is not None for x in ins)
    here = [x for x in ins if x is not None]
    if (tuple((x.dtype, x.shape) for x in here) == _expected_inputs(b, present)
            and all(x.is_contiguous() for x in here[4:7] + here[8:])
            and all(x.stride(-1) == 1 for x in here[:4] + here[7:8])
            and all(x.device == dev for x in here)):
        return ins
    checked = []
    for x, (dt, w), name in zip(ins, _IN_SPEC, IN_SLOTS):
        if x is None:
            checked.append(None)
            continue
        checked.append(_rows(x, b, -w, dt, name) if w < 0 else _dense(x, (b,) if w == 0 else (b, w), dt, name))
        if checked[-1].device != dev:
            raise ValueError("shade: every input must be on the lanes' card")
    return tuple(checked)


def _forward_cuda(call, want_grad: bool):
    """The forward kernel on ``call`` (``_Call``'s fields): one output
    allocation, one entry-point call; the variant with K7's scan folded in
    where the scene has primitives and the call gives no K7 hit; the
    radiance stored at ``idx`` where the call gives it.  Returns
    (:class:`Shaded`, :class:`ShadeResidual` or None)."""
    scene, st, u, res, prim, is_first, may_scatter, idx = _Call(*call)
    tp = st["throughput"]
    b = tp.shape[0]
    dev = tp.device
    if b >= 2**31:
        raise ValueError("shade: too many lanes for one launch")
    entry = _scene_entry(scene)
    if entry.device != dev:
        raise ValueError("shade: every input must be on the lanes' card")
    ins = _checked_inputs(_lane_inputs(scene, st, u, res, prim, idx), b, dev)
    outs, out_ptrs = _carve(b, want_grad, dev)
    out = Shaded(dict(zip(STATE_KEYS, outs[:7])), *outs[7:12])
    resid = ShadeResidual(outs[12], outs[13]) if want_grad else None
    if b == 0:  # an empty batch launches nothing
        return out, resid
    slots = LANE_ARRAY(*(None if x is None else x.data_ptr() for x in ins),
                       *(ins[k].stride(0) for k in (0, 1, 2, 3, 7)), *out_ptrs)
    lib = _library()
    scan = prim is None and entry.prims
    rc = on_current_stream(lib.shade_forward, dev.index, b, entry.tables_ref,
                           _flags(entry, scene, is_first, may_scatter, scan), slots, N_LANE_SLOTS)
    if rc != 0:
        raise RuntimeError(f"shade_forward launch failed: {lib.shade_error_string(rc).decode()}")
    shade.launches += 1
    shade.scan_launches += scan
    shade.idx_launches += idx is not None
    return out, resid


def _backward_cuda(albedo, throughput, resid: ShadeResidual, emittance, atlas_shape,
                   g_throughput, g_radiance, g_albedo, need, src=None, idx=None):
    """The backward kernel: the atlas and emittance gradients carved from
    one zero-filled allocation (one fill), one entry-point call.  ``src``
    ((B,) int32, after a compaction): the throughput's gradient and the
    radiance's pass-through are stored at row ``src[i]``, the rows from
    before the compaction (every row written, so no fill).  ``idx`` ((B,)
    int32, a frame's last bounce): row ``i``'s radiance cotangent is read at
    row ``idx[i]``."""
    b = albedo.shape[0]
    dev = albedo.device
    g_tp, g_rad, g_alb = (None if g is None else _dense(g.contiguous(), (b, k), torch.float32, f"the {name} cotangent")
                          for g, k, name in ((g_throughput, 3, "throughput"), (g_radiance, 3, "radiance"),
                                             (g_albedo, 4, "albedo")))
    d_tp = torch.empty((b, 3), dtype=torch.float32, device=dev) if need[0] else None
    # the radiance's pass-through: the cotangent itself, or moved (from idx's rows, to src's) by the kernel
    d_rad = g_radiance if need[1] else None
    moves_rad = (src is not None or idx is not None) and d_rad is not None
    if moves_rad:
        d_rad = torch.empty((b, 3), dtype=torch.float32, device=dev)
    d_atlas = d_emit = None
    if need[2] or need[3]:
        t, h, w = atlas_shape[:3]
        n_atlas = 4 * t * h * w if need[2] else 0
        zeros = torch.zeros(n_atlas + (emittance.shape[0] if need[3] else 0), dtype=torch.float32, device=dev)
        if need[2]:
            d_atlas = zeros.as_strided(atlas_shape, (h * w * 4, w * 4, 4, 1))
        if need[3]:
            d_emit = zeros.as_strided(emittance.shape, (1,), n_atlas)
    if b > 0 and (need[0] or need[2] or need[3] or moves_rad):
        lib = _library()
        tp = throughput.contiguous()
        slots = BACKWARD_ARRAY(_ptr(g_tp), _ptr(g_rad), _ptr(g_alb), albedo.data_ptr(), tp.data_ptr(),
                               resid.ints.data_ptr(), resid.floats.data_ptr(), emittance.data_ptr(), _ptr(d_tp),
                               _ptr(d_atlas), _ptr(d_emit), _ptr(src), _ptr(d_rad) if moves_rad else None,
                               _ptr(idx))
        rc = on_current_stream(lib.shade_backward, dev.index, b, slots, len(BACKWARD_SLOTS))
        if rc != 0:
            raise RuntimeError(f"shade_backward launch failed: {lib.shade_error_string(rc).decode()}")
        shade.backward_launches += 1
        shade.src_backward_launches += src is not None
        shade.idx_backward_launches += idx is not None
    return d_tp, d_rad, d_atlas, d_emit


def launch_configs(scene: Scene, b: int) -> dict:
    """How K4's kernels launch on ``b`` lanes of ``scene`` (on the current
    card): {"forward": {...}, "backward": {...}}, each with threads, blocks,
    dynamic shared memory bytes per block, resident blocks per SM, SMs,
    registers per thread and stack frame bytes; the forward's with the
    variant the scene's bounces take ("scan": K7's scan folded in, on a
    scene with primitives; else "plain") and where its tables are read
    (shared memory, or global memory through __ldg above
    ``csrc/shade.cu``'s K4_TABLE_SMEM_BUDGET), the backward's with how it
    sums (warp-combined atomics)."""
    entry = _scene_entry(scene)
    lib = _library()
    keys = ("threads", "blocks", "smem_bytes", "resident_blocks_per_sm", "sms")
    fwd, bwd = (ctypes.c_int * 8)(), (ctypes.c_int * 8)()
    with torch.cuda.device(entry.device):
        for rc in (lib.shade_forward_config(b, ctypes.byref(entry.tables), int(entry.prims), fwd),
                   lib.shade_backward_config(b, bwd)):
            if rc != 0:
                raise RuntimeError(f"shade launch configuration failed: {lib.shade_error_string(rc).decode()}")
    return {"forward": dict(zip(keys, fwd[:5]), tables="shared memory" if fwd[5] else "__ldg",
                            variant="scan" if entry.prims else "plain", registers=fwd[6], stack_bytes=fwd[7]),
            "backward": dict(zip(keys, bwd[:5]), sums="warp-combined", registers=bwd[6], stack_bytes=bwd[7])}
