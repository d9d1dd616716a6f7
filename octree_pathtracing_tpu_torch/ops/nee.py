"""Kernel K4's next-event half and kernel K6, the emitter pick: the sun and
emitter next-event estimates of one bounce with the shadow-attenuation
recompute, forward and backward (port of ``render/pathtracer.py``
``_shade`` :1361-1504, ``shadow_attenuation`` and the recompute, and of
``models/emitters.py`` ``_spatial_pick``, ``sample_emitter_point`` and
``toward_face_sample``).

A bounce that samples light casts F shadow rays per lane, one per *face*:
face 0 toward the sun where the scene samples it (FAST, HIGH_QUALITY),
then the emitter faces: one sampled point of one spatially picked emitter
(``EmitterSampling.ONE``), the 3 toward faces of one uniformly picked
emitter (ONE_BLOCK), or the 3 toward faces of every emitter (ALL).  Three
steps, in this order:

1. :func:`nee_setup_reference` (kernel ``nee_setup``): from K4's hand-off
   (``ops/shade.Shaded``) and the uniforms, every face's shadow ray (the
   walk's origin and direction, whether it is cast, ``max_t``) and what the
   resolve reads of it (a geometry scale, the emitter's texel and
   material), face-major: ray ``f * B + i`` is lane ``i``'s face ``f``; on
   the card, in a scene with primitives, the kernel also scans each cast
   ray against them (K7 folded in) and writes its hit beside the ray;
2. :func:`nee_walks`: the bounce's shadow walks, all faces in one call of
   the existing kernels (K1 / K2 on ``shadow_binary`` scenes, K3s
   otherwise; K7 for primitives where ``nee_setup`` did not scan them);
3. :func:`nee_resolve_reference` (kernel ``nee_resolve``): per face the
   attenuation recomputed from the walk's records (up to ``K_SURFACES``
   texels, then the nearest primitive), the sun term or the emitter's
   ``albedo * L_e * att * geom * inv_pdf``, added with the throughput to
   the radiance K4 wrote; with a gradient, a residual of 36 bytes per face
   and lane.

:func:`nee_backward_reference` (kernel ``nee_backward``) is the gradient,
written out: the throughput's and the shading point's albedo's (which
reaches the atlas through K4's backward), and the blockers' and emitters'
texels and the emitters' emittance, scatter-added.  The geometry stays
detached, as in JAX.

:func:`nee` runs the three kernels of ``csrc/nee.cu`` and the walks on
CUDA tensors through :class:`NeeFunction`, and the plain versions on CPU
tensors; there is no fallback from one to the other.  After a compaction
(the state's ``lanes``, ``ops/compact.Lanes``) the differentiable
throughput is the one from before it, and the backward stores each lane's
throughput gradient at the row it came from (``lanes.src``).  On a frame's
last bounce ``nee_resolve`` writes the frame's final radiance: given the
compaction's ``idx`` it stores row ``i``'s at row ``idx[i]`` (the lanes' own
order, the unpermute after the bounce loop folded into the store), and
``nee_backward`` reads the radiance cotangent at row ``idx[i]`` and hands it
on to K4's radiance in row order.
"""

from __future__ import annotations

import ctypes
import functools
import math
import operator
from typing import NamedTuple

import numpy as np
import torch

from ..models.emitters import ALL_MAX_EMITTERS, sample_emitter_point, toward_face_sample
from ..models.materials import FLAG_SUBSURFACE_SCATTER
from ..models.prims import intersect_prims
from ..models import prims as k7
from ..models.scene import MAX_DIST, EmitterSampling, Scene
from ..models.sun import random_sun_direction
from ..utils.cuda_build import on_current_stream
from . import compact as k5
from . import shade as k4
from .shade import _atlas_data, _folds, _ptr, resolve_hit
from .shading import EPSILON, N_UNIFORMS, OFFSET, U_EM1, U_EM2, U_EM_PICK, U_SUBSURFACE, U_SUN1, U_SUN2
from .texture import Atlas, sample_atlas, texel_index
from .traversal import K_SURFACES, traverse, traverse_alpha, traverse_shadow

# the attenuation's slots: the walk's K_SURFACES surfaces, then the primitive
N_SLOTS = K_SURFACES + 1
# the residual's ints per face and lane: a code (bit 0: the face is cast;
# bit 1 + s: slot s's strict-IOR zero), the texel of each slot (-1 where it
# did not attenuate), the emitter's texel and material (-1 on the sun face)
RESID_INTS = 3 + N_SLOTS
CODE_ON, ZERO_SHIFT = 1, 1
EM_MODES = {EmitterSampling.ONE: 1, EmitterSampling.ONE_BLOCK: 2, EmitterSampling.ALL: 3}
MAX_GRID_K = 64  # the widest supercell row the kernel takes


class NeePlan(NamedTuple):
    """What one bounce of a scene samples: a sun face (face 0) and the
    emitter faces of ``emitters`` (an ``EmitterSampling`` value, or None)."""

    sun: bool
    emitters: str | None
    faces: int


def nee_plan(scene: Scene) -> NeePlan | None:
    """The scene's faces per lane, or None where it samples no light.
    Raises where ``EmitterSampling.ALL`` meets more than
    ``ALL_MAX_EMITTERS`` emitters."""
    sun = bool(scene.sun_sampling.sun_sampling)
    em = scene.emitters
    mode = scene.emitter_sampling
    if mode == EmitterSampling.NONE or em is None or not scene.emitters_enabled:
        mode = None
    e_cnt = 0 if mode is None else em.count
    if mode == EmitterSampling.ALL and e_cnt > ALL_MAX_EMITTERS:
        raise ValueError(
            f"EmitterSampling.ALL sums 3 shadow traversals per "
            f"emitter per diffuse bounce — O(E) work; this scene has "
            f"E={e_cnt} > {ALL_MAX_EMITTERS}.  Use EmitterSampling."
            f"ONE (spatially-selected, O(1) per bounce) for large "
            f"emitter tables."
        )
    em_faces = {None: 0, EmitterSampling.ONE: 1, EmitterSampling.ONE_BLOCK: 3}.get(mode, 3 * e_cnt)
    faces = int(sun) + em_faces
    return NeePlan(sun, mode, faces) if faces else None


class NeeRays(NamedTuple):
    """``nee_setup``'s output, face-major over F faces of B lanes (row
    ``f * B + i``): the shadow rays and what ``nee_resolve`` reads of each."""

    origin: torch.Tensor  # (F*B, 3) the walk's origin (the shading point + OFFSET along dir)
    dir: torch.Tensor  # (F*B, 3)
    max_t: torch.Tensor  # (F*B,) surfaces at or beyond it do not attenuate (inf on the sun face)
    scale: torch.Tensor  # (F*B,) |cos| * the luminosity pdf (sun); geom * inv_pdf (emitter)
    active: torch.Tensor  # (F*B,) bool: the face is cast
    cur_mat: torch.Tensor  # (F*B,) int32 the lane's medium, the walk's input
    e_texel: torch.Tensor  # (F*B,) int32 the emitter point's texel (-1 on the sun face)
    e_mat: torch.Tensor  # (F*B,) int32 the emitter's material (-1 on the sun face)
    # K7's hit of each cast ray (a miss on a ray not cast), where the kernel
    # scanned the scene's primitives; None otherwise
    p_hit: torch.Tensor | None = None  # (F*B,) bool
    p_t: torch.Tensor | None = None  # (F*B,)
    p_mat: torch.Tensor | None = None  # (F*B,) int32
    p_uv: torch.Tensor | None = None  # (F*B, 2)

    @property
    def prim(self):
        """(hit, t, mat, uv, None) of the scan ``nee_setup`` folded in, or
        None."""
        return None if self.p_hit is None else (self.p_hit, self.p_t, self.p_mat, self.p_uv, None)


class NeeResidual(NamedTuple):
    """What the backward reads besides the albedo, the throughput, the atlas
    and the emittance: ``ints`` (F, B, RESID_INTS) int32 and ``scale`` (F, B)
    (``NeeRays.scale``)."""

    ints: torch.Tensor
    scale: torch.Tensor


# ---- the plain versions

def _emitter_points(scene: Scene, plan: NeePlan, p, n, u):
    """K6: the sampled emitter points of every emitter face, in face order:
    (q (B, 3), outward normal (B, 3), material (B,), uv (B, 2), inv_pdf
    (B,)).  ONE_BLOCK and ALL reuse the (U_EM1, U_EM2) pair for every face,
    as the reference does (unbiased; the face samples correlate)."""
    em = scene.emitters
    if plan.emitters == EmitterSampling.ONE:
        smp = sample_emitter_point(em, p, u[:, U_EM_PICK], u[:, U_EM1], u[:, U_EM2], n=n)
        return [(smp["q"], smp["ne"], smp["mat"], smp["uv"], smp["inv_pdf"])]
    e_cnt, b = em.count, p.shape[0]
    if plan.emitters == EmitterSampling.ONE_BLOCK:
        idx = torch.clamp((u[:, U_EM_PICK] * e_cnt).to(torch.int32), max=e_cnt - 1).long()
        picks = [(em.pos[idx], em.size[idx], em.mat[idx])]
        inv_pdf = float(e_cnt) * picks[0][1] * picks[0][1]
    else:  # ALL: every emitter, a deterministic block sum with no pick factor
        picks = [(em.pos[i].expand(b, 3), em.size[i].expand(b), em.mat[i].expand(b)) for i in range(e_cnt)]
    out = []
    for pos_e, size_e, mat_e in picks:
        if plan.emitters == EmitterSampling.ALL:
            inv_pdf = size_e * size_e
        for axis in range(3):
            q, ne, uv = toward_face_sample(pos_e, size_e, p, axis, u[:, U_EM1], u[:, U_EM2])
            out.append((q, ne, mat_e, uv, inv_pdf))
    return out


def nee_setup_reference(scene: Scene, plan: NeePlan, cur_mat, u, hitpoint, normal, mat, diffuse_on) -> NeeRays:
    """Plain twin of ``nee_setup`` (any device): every face's shadow ray from
    K4's hand-off (``hitpoint``, ``normal``, ``mat``, ``diffuse_on``), the
    lane's medium ``cur_mat`` and the uniforms ``u`` (B, N_UNIFORMS)."""
    b = cur_mat.shape[0]
    inf = torch.full((b,), float("inf"), dtype=torch.float32, device=cur_mat.device)
    none = torch.full((b,), -1, dtype=torch.int32, device=cur_mat.device)
    faces = []
    if plan.sun:
        sun_dir = random_sun_direction(scene.sun, u[:, U_SUN1], u[:, U_SUN2])
        cos_sun = torch.sum(sun_dir * normal, dim=-1)
        front = cos_sun > 0.0
        flags = scene.materials.flags[mat.long()]
        sss = ((flags & FLAG_SUBSURFACE_SCATTER) != 0) & (u[:, U_SUBSURFACE] < scene.f_sub_surface)
        shadow_on = diffuse_on & (front | sss)
        origin = torch.where(front[:, None], hitpoint, hitpoint - OFFSET * normal)
        lum = scene.sun.luminosity_pdf if scene.sun_sampling.sun_luminosity else 1.0
        faces.append((origin + sun_dir * OFFSET, sun_dir, inf, torch.abs(cos_sun) * lum, shadow_on, none, none))
    if plan.emitters is not None:
        # A lane off the diffuse lobe casts nothing, but a miss's hit point
        # lies at infinity; a finite stand-in keeps every term finite.
        p = torch.where(diffuse_on[:, None], hitpoint, 0.0)
        for q, ne, mat_e, uv, inv_pdf in _emitter_points(scene, plan, p, normal, u):
            to_q = q - p
            # sqrt(max(., eps^2)) keeps the terms finite where q == p
            dist = torch.sqrt(torch.clamp(torch.sum(to_q * to_q, -1), min=EPSILON * EPSILON))
            wi = to_q / dist[:, None]
            cos_s = torch.sum(wi * normal, dim=-1)
            cos_e = torch.sum(-wi * ne, dim=-1)
            on = diffuse_on & (cos_s > 0.0) & (cos_e > 0.0)
            geom = cos_s * cos_e / torch.clamp(dist * dist, min=EPSILON) / math.pi
            layer = scene.materials.texture_index[mat_e.long()]
            texel = texel_index(scene.atlas, layer, uv[:, 0], uv[:, 1]).to(torch.int32)
            # the walk stops just short of the emitter: its own entry face never shadows it
            faces.append((p + wi * OFFSET, wi, dist * (1.0 - 1e-3), geom * inv_pdf, on, texel, mat_e))
    cols = [torch.cat(col) for col in zip(*faces)]
    return NeeRays(*cols[:5], cur_mat.to(torch.int32).repeat(plan.faces), cols[5], cols[6].to(torch.int32))


def nee_walks(scene: Scene, plan: NeePlan, rays: NeeRays):
    """The shadow walks of every face of a bounce in one call each, detached:
    (the walk's record, K7's hit or None).  K7's hit is the one ``nee_setup``
    wrote beside the rays where it scanned them, else one K7 call over
    every ray (``models/prims.intersect_prims``).  On ``shadow_binary`` scenes
    (every texel alpha exactly 1, no quad models) the first surface always
    spends the whole budget, so a first-hit walk (K1 / K2, a ``HitResult``)
    stands for the stateful one; otherwise K3s records each surface
    (``ShadowState``, with ts where a face has a ``max_t``)."""
    from ..render.hit import accept_tables

    head = (scene.nodes, scene.root, scene.depth, scene.octree_scale, rays.origin, rays.dir)
    if not scene.shadow_binary:
        walk = traverse_shadow(*head, accept_tables(scene), rays.cur_mat, scene.sun_sampling.strict_direct_light,
                               plan.emitters is not None, MAX_DIST, rays.active)[1]
    elif scene.opaque_only:
        walk = traverse(*head, MAX_DIST, rays.active)
    else:
        walk = traverse_alpha(*head, accept_tables(scene), MAX_DIST, rays.active)
    prim = rays.prim
    if prim is None and scene.prims is not None:
        prim = intersect_prims(scene.prims, rays.origin, rays.dir, MAX_DIST)
    return walk, prim


def _albedo_at(scene: Scene, mat, u, v):
    """(B, 4) texel of material ``mat`` at (u, v), differentiable in the
    atlas, and its linear index."""
    layer = scene.materials.texture_index[mat.long()]
    return sample_atlas(scene.atlas, layer, u, v), texel_index(scene.atlas, layer, u, v)


def _factor(albedo):
    """A surface's attenuation factors: rgb ``albedo * alpha + (1 - alpha)``
    and the budget's ``1 - alpha``."""
    mult = 1.0 - albedo[:, 3]
    return albedo[:, :3] * albedo[:, 3:4] + mult[:, None], mult


def stateful_chain(scene: Scene, st, cur_mat, max_t, strict: bool):
    """The attenuation recompute from a stateful walk's records
    (``ops/traversal.ShadowState``) for lanes whose medium was ``cur_mat``:
    per surface rgb *= albedo * alpha + (1 - alpha) and w *= 1 - alpha,
    strict mode zeroing w on an IOR change; surfaces at or beyond
    ``max_t`` (None: no cut; it needs ``st.ts``) do not attenuate.
    Differentiable in the atlas.  Returns (rgb (B, 3), w (B,), the texel of
    each surface that attenuated (K, B) (-1 elsewhere), the strict zeros
    (K, B))."""
    b = cur_mat.shape[0]
    att_rgb = torch.ones((b, 3), dtype=torch.float32, device=cur_mat.device)
    w = torch.ones((b,), dtype=torch.float32, device=cur_mat.device)
    cm = cur_mat
    ior = scene.materials.ior
    texels, zeros = [], []
    for k in range(K_SURFACES):
        mat = st.mats[k]
        albedo, texel = _albedo_at(scene, mat, st.uu[k], st.vv[k])
        f_rgb, mult = _factor(albedo)
        new_rgb = att_rgb * f_rgb
        new_w = w * mult
        zero = torch.zeros_like(st.count, dtype=torch.bool)
        if strict:
            zero = ior[cm.long()] != ior[mat.long()]
            new_w = torch.where(zero, 0.0, new_w)
        upd = (k < st.count) & (w > 0.0)
        if max_t is not None:
            upd = upd & (st.ts[k] < max_t)
        att_rgb = torch.where(upd[:, None], new_rgb, att_rgb)
        w = torch.where(upd, new_w, w)
        cm = torch.where(upd, mat, cm)
        texels.append(torch.where(upd, texel, -1))
        zeros.append(upd & zero)
    return att_rgb, w, torch.stack(texels), torch.stack(zeros)


def binary_chain(scene: Scene, res, cur_mat, max_t, strict: bool):
    """The binary walk's attenuation from its first hit ``res``: the one
    surface, where it lies short of ``max_t`` (None: no cut; the walk's t
    is measured from its own origin and compared as it is, as the reference
    does).  Returns as :func:`stateful_chain`, with one surface."""
    mat, uv, _, t_hit = resolve_hit(scene, None, None, res)
    blocked = res.hit
    if max_t is not None:
        blocked = blocked & (t_hit < max_t)
    albedo, texel = _albedo_at(scene, mat, uv[:, 0], uv[:, 1])
    f_rgb, mult = _factor(albedo)
    att_rgb = torch.where(blocked[:, None], f_rgb, 1.0)
    w = torch.where(blocked, mult, 1.0)
    zero = torch.zeros_like(blocked)
    if strict:
        zero = blocked & (scene.materials.ior[cur_mat.long()] != scene.materials.ior[mat.long()])
        w = torch.where(zero, 0.0, w)
    return att_rgb, w, torch.where(blocked, texel, -1)[None], zero[None]


def prim_fold(scene: Scene, prim, cur_mat, att_rgb, w, max_t, strict: bool):
    """Fold K7's hit ``prim`` into an attenuation: the nearest primitive
    short of ``max_t`` (None: no cut) contributes one factor, with the
    strict-IOR zero against the lane's medium ``cur_mat``; a translucent
    primitive behind another is not walked on to.  Returns (att (B, 4), its
    texel (B,) (-1 where it did not attenuate), its strict zero (B,))."""
    p_hit, p_t, p_mat, p_uv, _ = prim
    if max_t is not None:
        p_hit = p_hit & (p_t < max_t)
    albedo_p, texel = _albedo_at(scene, p_mat, p_uv[:, 0], p_uv[:, 1])
    f_rgb, mult_p = _factor(albedo_p)
    att_rgb = torch.where(p_hit[:, None], att_rgb * f_rgb, att_rgb)
    new_w = w * mult_p
    zero = torch.zeros_like(p_hit)
    if strict:
        ior = scene.materials.ior
        zero = p_hit & (ior[cur_mat.long()] != ior[p_mat.long()])
        new_w = torch.where(zero, 0.0, new_w)
    w = torch.where(p_hit, new_w, w)
    return torch.cat([att_rgb, w[:, None]], -1), torch.where(p_hit, texel, -1), zero


def _face(walk, sl):
    """Face ``sl``'s rows of a walk's record: a ``HitResult`` is lane-major,
    a ``ShadowState`` (K, F*B)."""
    if hasattr(walk, "mats"):  # ShadowState
        return type(walk)(*(None if x is None else (x[sl] if x.dim() == 1 else x[:, sl]) for x in walk))
    return walk._replace(**{f: getattr(walk, f)[sl] for f in ("hit", "t", "face_id", "uv", "leaf_value")})


def attenuation_reference(scene: Scene, walk, prim, cur_mat, max_t):
    """One face's attenuation (B, 4) (rgb and the budget w) from its walk's
    record and K7's hit (or None), differentiable in the atlas, and its
    residual slots: (texels (N_SLOTS, B) int64, strict zeros (N_SLOTS, B))."""
    strict = scene.sun_sampling.strict_direct_light
    b = cur_mat.shape[0]
    if scene.shadow_binary:
        att_rgb, w, texels, zeros = binary_chain(scene, walk, cur_mat, max_t, strict)
    else:
        att_rgb, w, texels, zeros = stateful_chain(scene, walk, cur_mat, max_t if walk.ts is not None else None,
                                                   strict)
    pad = N_SLOTS - 1 - texels.shape[0]
    texels = torch.cat([texels, texels.new_full((pad, b), -1)])
    zeros = torch.cat([zeros, zeros.new_zeros((pad, b))])
    if prim is None:
        p_tex, p_zero = texels.new_full((b,), -1), zeros.new_zeros((b,))
        att = torch.cat([att_rgb, w[:, None]], -1)
    else:
        att, p_tex, p_zero = prim_fold(scene, prim, cur_mat, att_rgb, w, max_t, strict)
    return att, torch.cat([texels, p_tex[None]]), torch.cat([zeros, p_zero[None]])


def _nee_terms(scene: Scene, plan: NeePlan, rays: NeeRays, walk, prim, albedo, cur_mat, want_resid: bool):
    """The sun term (B, 3) before the throughput and its mask, the emitter
    sum (B, 3) before the throughput (each None where the plan has none),
    and the residual's ints (F, B, RESID_INTS) (None unless wanted)."""
    b = cur_mat.shape[0]
    data = _atlas_data(scene.atlas)
    flat = data.reshape(-1, 4)
    sun_nee = sun_on = em_acc = None
    ints = []
    for f in range(plan.faces):
        sl = slice(f * b, (f + 1) * b)
        on, scale = rays.active[sl], rays.scale[sl]
        face_prim = None if prim is None else tuple(None if x is None else x[sl] for x in prim)
        att, texels, zeros = attenuation_reference(scene, _face(walk, sl), face_prim, cur_mat, rays.max_t[sl])
        if plan.sun and f == 0:
            mult = scale * att[:, 3]
            sun_nee = albedo[:, :3] * (att[:, :3] * mult[:, None]) * scene.sun.emittance[None, :3]
            sun_on = on
        else:
            albedo_e = flat[rays.e_texel[sl].long()]
            l_e = albedo_e[:, :3] * albedo_e[:, :3] * scene.materials.emittance[rays.e_mat[sl].long()][:, None]
            contrib = albedo[:, :3] * l_e * att[:, :3] * (scale * att[:, 3])[:, None]
            contrib = torch.where(on[:, None], contrib, 0.0)
            if plan.emitters == EmitterSampling.ONE:
                em_acc = contrib
            else:
                em_acc = (torch.zeros_like(contrib) if em_acc is None else em_acc) + contrib
        if want_resid:  # a face not cast keeps no slot (K7 scans every lane)
            texels = torch.where(on, texels, -1)
            code = on.int() * CODE_ON
            for s in range(N_SLOTS):
                code = code | ((zeros[s] & on).int() << (ZERO_SHIFT + s))
            ints.append(torch.stack([code, *texels.int(), rays.e_texel[sl], rays.e_mat[sl]], -1))
    return sun_nee, sun_on, em_acc, torch.stack(ints) if want_resid else None


def nee_resolve_reference(scene: Scene, plan: NeePlan, rays: NeeRays, walk, prim, albedo, throughput, radiance,
                          cur_mat, want_resid: bool = True, idx=None):
    """Plain twin of ``nee_resolve`` (any device): the radiance K4 wrote plus
    ``throughput * (sun + emitters)``, differentiable in the atlas, the
    emittance, the albedo, the throughput and the radiance; row ``i`` at row
    ``idx[i]`` where ``idx`` is given (a frame's last bounce,
    ``ops/compact.unpermute_reference``).  Returns (radiance (B, 3),
    :class:`NeeResidual` or None)."""
    sun_nee, sun_on, em_acc, ints = _nee_terms(scene, plan, rays, walk, prim, albedo, cur_mat, want_resid)
    if sun_nee is not None:
        radiance = radiance + torch.where(sun_on[:, None], throughput * sun_nee, 0.0)
    if em_acc is not None:
        radiance = radiance + throughput * em_acc
    if idx is not None:
        radiance = k5.unpermute_reference(radiance, idx)
    b = cur_mat.shape[0]
    return radiance, (NeeResidual(ints, rays.scale.reshape(plan.faces, b)) if want_resid else None)


def nee_reference(scene: Scene, st: dict, u, out, idx=None):
    """The next-event half of one bounce through the plain versions (the
    walks through their wrappers): K4's hand-off ``out`` (``Shaded``) and
    the incoming state ``st`` in, (radiance (B, 3), :class:`NeeResidual`)
    out; differentiable by autograd like the eager code it is (after a
    compaction, ``st["lanes"]``, the throughput rows are gathered from the
    throughput before it, so that its gradient reaches that).  ``idx``: as
    :func:`nee`'s."""
    plan = nee_plan(scene)
    if plan is None:
        _no_plan_for(idx)
        return out.state["radiance"], None
    rays = nee_setup_reference(scene, plan, st["cur_mat"], u, out.hitpoint, out.normal, out.mat, out.diffuse_on)
    walk, prim = nee_walks(scene, plan, rays)
    tp, lanes = st["throughput"], st.get("lanes")
    if lanes is not None:  # row j came from lane src[j]: the same rows, differentiable in the lanes' throughput
        tp = lanes.throughput[lanes.src.long()]
    return nee_resolve_reference(scene, plan, rays, walk, prim, out.albedo, tp, out.state["radiance"], st["cur_mat"],
                                 idx=idx)


def _sum3(x):
    """A sum over a last axis of 3 in the order the card's reduction adds."""
    return (x[..., 0] + x[..., 2]) + x[..., 1]


def nee_backward_reference(albedo, throughput, resid: NeeResidual, atlas, emittance, sun_emittance, plan: NeePlan,
                           g_radiance, need=(True, True, True, True, True), idx=None):
    """Plain twin of ``nee_backward`` (any device): the gradients of one
    bounce's next-event terms from the radiance cotangent, written out as
    formulas.  ``albedo`` (B, 4) and ``throughput`` (B, 3) are the forward's
    inputs, ``atlas`` the texels (T, H, W, 4), ``sun_emittance`` the sun's
    (4,).  ``need``: which of (throughput, radiance, albedo, atlas,
    emittance) to return (None otherwise).

    Returns (d throughput (B, 3), d radiance, d albedo (B, 4), d atlas, d
    emittance): the albedo's alpha takes none; the blockers' texels take
    rgba, the emitters' texels rgb, the emitters' materials the emittance.
    The last two are summed in float64 (as the kernel sums them: under ALL
    ~10^7 terms can fall on one material) and returned in float32.  ``idx``:
    the forward's (a frame's last bounce), whose radiance cotangent row
    ``i`` is read at row ``idx[i]`` (``ops/compact.unpermute_backward_reference``);
    the radiance's gradient is then that gathered cotangent, in row order."""
    if idx is not None:
        g_radiance = k5.unpermute_backward_reference(g_radiance, idx)
    b = albedo.shape[0]
    flat = atlas.reshape(-1, 4)
    g = g_radiance
    h = g * throughput
    alb = albedo[:, :3]
    d_tp = torch.zeros_like(throughput)
    d_alb = torch.zeros_like(albedo)
    d_atlas = torch.zeros_like(flat, dtype=torch.float64)
    d_emit = torch.zeros_like(emittance, dtype=torch.float64)
    acc = torch.zeros_like(throughput)
    for f in range(plan.faces):
        ints = resid.ints[f].long()
        code, texels, e_texel, e_mat = ints[:, 0], ints[:, 1:1 + N_SLOTS].T, ints[:, -2], ints[:, -1]
        on = ((code & CODE_ON) != 0)[:, None]
        scale = resid.scale[f]
        # the chain's values before each slot, from the texels it read
        used = texels >= 0
        a = flat[texels.clamp(min=0)]  # (N_SLOTS, B, 4)
        f_rgb = a[..., :3] * a[..., 3:4] + (1.0 - a[..., 3])[..., None]
        m = 1.0 - a[..., 3]
        zero = torch.stack([((code >> (ZERO_SHIFT + s)) & 1) != 0 for s in range(N_SLOTS)])
        att_pre, w_pre = [torch.ones_like(alb)], [torch.ones_like(scale)]
        for s in range(N_SLOTS):
            att_pre.append(torch.where(used[s][:, None], att_pre[-1] * f_rgb[s], att_pre[-1]))
            w_pre.append(torch.where(used[s], torch.where(zero[s], 0.0, w_pre[-1] * m[s]), w_pre[-1]))
        att, w = att_pre[-1], w_pre[-1]
        if plan.sun and f == 0:
            mult = scale * w
            nee = alb * (att * mult[:, None]) * sun_emittance[None, :3]
            d_tp = d_tp + torch.where(on, g * nee, 0.0)
            d_x = torch.where(on, h, 0.0) * sun_emittance[None, :3]
            d_alb[:, :3] += d_x * (att * mult[:, None])
            d_y = d_x * alb
            d_att = d_y * mult[:, None]
            d_w = _sum3(d_y * att) * scale
        else:
            ae = flat[e_texel.clamp(min=0)][:, :3]
            e = emittance[e_mat.clamp(min=0)][:, None]
            s_ = scale * w
            le = ae * ae * e
            y = alb * le
            x = y * att
            acc = acc + torch.where(on, x * s_[:, None], 0.0)
            d_x = torch.where(on, h, 0.0) * s_[:, None]
            d_y = d_x * att
            d_att = d_x * y
            d_alb[:, :3] += d_y * le
            d_le = d_y * alb
            d_ae = 2.0 * (d_le * e) * ae
            d_w = _sum3(torch.where(on, h, 0.0) * x) * scale
            sel = on[:, 0]
            d_atlas[:, :3].index_put_((e_texel[sel],), d_ae[sel].double(), accumulate=True)
            d_emit.index_put_((e_mat[sel],), _sum3(d_le * (ae * ae))[sel].double(), accumulate=True)
        for s in reversed(range(N_SLOTS)):
            sel = used[s] & on[:, 0]
            d_f = d_att * att_pre[s]
            d_att = torch.where(used[s][:, None], d_att * f_rgb[s], d_att)
            d_m = torch.where(zero[s], 0.0, d_w * w_pre[s])
            d_w = torch.where(used[s], torch.where(zero[s], 0.0, d_w * m[s]), d_w)
            d_a = torch.cat([d_f * a[s][:, 3:4], (_sum3(d_f * a[s][:, :3]) - (_sum3(d_f) + d_m))[:, None]], -1)
            d_atlas.index_put_((texels[s][sel],), d_a[sel].double(), accumulate=True)
    if plan.emitters is not None:
        d_tp = d_tp + g * acc
    return (d_tp if need[0] else None, g if need[1] else None, d_alb if need[2] else None,
            d_atlas.view(atlas.shape).float() if need[3] else None, d_emit.float() if need[4] else None)


# ---- the autograd function and the wrapper

class _Call(NamedTuple):
    """One call's arguments other than the five that carry gradient."""

    scene: Scene
    plan: NeePlan
    cur_mat: torch.Tensor
    u: torch.Tensor
    hitpoint: torch.Tensor
    normal: torch.Tensor
    mat: torch.Tensor
    diffuse_on: torch.Tensor


class NeeFunction(torch.autograd.Function):
    """The next-event half of one bounce as an autograd function of
    (throughput, radiance, albedo, atlas texels, emittance), the rest of the
    call in ``call`` (and, on the card, the scene's cached ``entry``);
    returns the new radiance (B, 3).  CUDA tensors run the kernels of
    ``csrc/nee.cu`` and the walks' kernels, CPU tensors the plain
    versions.  ``lanes`` (after a compaction): (the compacted throughput
    rows the kernels read, ``ops/compact.Lanes``); the throughput given is
    then the one from before the compaction, and the backward moves its
    gradient back through it.  ``idx`` (a frame's last bounce): the radiance
    returned is in the lanes' own order, and so is its cotangent."""

    @staticmethod
    def forward(ctx, throughput, radiance, albedo, atlas, emittance, call: _Call, entry=None, lanes=None, idx=None):
        want_grad = any(ctx.needs_input_grad[:5])
        cuda = _uses_kernels(throughput)
        rows = throughput if lanes is None else lanes[0]
        if cuda:
            out, resid = _forward_cuda(call, rows, radiance, albedo, want_grad, entry, idx)
        else:
            c = call
            rays = nee_setup_reference(c.scene, c.plan, c.cur_mat, c.u, c.hitpoint, c.normal, c.mat, c.diffuse_on)
            walk, prim = nee_walks(c.scene, c.plan, rays)
            out, resid = nee_resolve_reference(c.scene, c.plan, rays, walk, prim, albedo, rows, radiance,
                                               c.cur_mat, want_grad, idx)
        ctx.set_materialize_grads(False)
        if want_grad:
            ctx.save_for_backward(albedo, rows, resid.ints, resid.scale, atlas, emittance, call.scene.sun.emittance,
                                  None if lanes is None else lanes[1].src, idx)
            ctx.plan = call.plan
        return out

    @staticmethod
    def backward(ctx, g_radiance):
        need = ctx.needs_input_grad[:5]
        if g_radiance is None:
            return (None,) * 9
        albedo, throughput, ints, scale, atlas, emittance, sun_emittance, src, idx = ctx.saved_tensors
        args = (albedo, throughput, NeeResidual(ints, scale), atlas, emittance, sun_emittance, ctx.plan,
                g_radiance, need)
        if _uses_kernels(albedo):
            d = _backward_cuda(*args, **_folds(src, idx))
        else:
            d = nee_backward_reference(*args, idx=idx)
            if src is not None:  # each row's gradient back at the lane it came from, as the kernel stores it
                d = (*k5.store_at_src_reference(src, d[0]), *d[1:])
        return (*d, None, None, None, None)


def _uses_kernels(x) -> bool:
    """Whether ``x``'s device runs the kernels of ``csrc/nee.cu`` (a CUDA
    tensor) rather than the plain versions (a CPU tensor)."""
    return x.is_cuda


# the scenes' plans, the newest last: [(sun sampling, emitter sampling,
# emitters enabled, the emitter table, plan)]
_PLANS: list = []
_PLANS_SIZE = 8


def _scene_plan(scene: Scene) -> NeePlan | None:
    """:func:`nee_plan` of ``scene``, computed once per scene (keyed by the
    settings it reads and the emitter table's identity).  A plan that
    raises is not kept, so it raises on every call."""
    ss, mode, on, em = scene.sun_sampling.sun_sampling, scene.emitter_sampling, scene.emitters_enabled, scene.emitters
    for e in reversed(_PLANS):
        if e[3] is em and e[0] == ss and e[1] == mode and e[2] == on:
            return e[4]
    plan = nee_plan(scene)
    _PLANS.append((ss, mode, on, em, plan))
    del _PLANS[:-_PLANS_SIZE]
    return plan


def _scene_no_grad(scene: Scene) -> tuple:
    """The scene's tensors the next-event terms read but do not
    differentiate: (name, tensor) pairs."""
    sun, em = scene.sun, scene.emitters
    named = [("materials.ior", scene.materials.ior)]
    named += [(f"sun.{f}", getattr(sun, f)) for f in ("su", "sv", "sw", "radius_cos", "emittance", "luminosity")]
    if em is not None:
        named += [(f"emitters.{f}", getattr(em, f)) for f in ("pos", "size", "grid_w") if getattr(em, f) is not None]
    return tuple(named)


def _check_no_other_grad(no_grad: tuple, u, out):
    """Raise where a tensor the next-event terms read, other than the
    throughput, the radiance, the albedo, the atlas texels and the
    emittance, requires grad: nothing may be dropped silently.  One pass;
    the names are built only to raise.  (``requires_grad`` can be set in
    place, so this runs on every call.)"""
    per_call = (("uniforms", u), ("hand-off.hitpoint", out.hitpoint), ("hand-off.normal", out.normal))
    if not any(x.requires_grad for _, x in no_grad + per_call):
        return
    bad = [name for name, x in no_grad + per_call if x.requires_grad]
    raise ValueError(f"nee: the next-event kernels differentiate only the throughput, radiance, albedo, atlas "
                     f"and emittance; {bad} require grad")


def _no_plan_for(idx):
    """Raise where a caller hands the final bounce's ``idx`` to the
    next-event half of a scene that samples no light: K4 writes the final
    radiance there, and it must be the one given ``idx``."""
    if idx is not None:
        raise ValueError("nee: the scene samples no light, so K4 writes the final radiance; give idx to K4 "
                         "(ops/shade.shade), not to nee")


def samples_light(scene: Scene) -> bool:
    """Whether a bounce of ``scene`` runs the next-event kernels (it has
    a plan, one cached lookup): then ``nee_resolve`` writes a bounce's
    radiance, otherwise K4 does."""
    return _scene_plan(scene) is not None


def nee(scene: Scene, st: dict, u, out, prim_slots: bool = True, idx=None):
    """The next-event half of one bounce (see the module's text): the new
    radiance (B, 3) from the incoming state ``st`` (with ``lanes`` after a
    compaction: the differentiable throughput is then ``lanes.throughput``),
    the uniforms ``u`` and K4's hand-off ``out`` (``ops/shade.Shaded``); K4's
    radiance where the scene samples no light (one cached lookup of its
    plan).  CUDA tensors launch ``nee_setup`` and ``nee_resolve`` (counted
    in ``nee.setup_launches`` and ``nee.resolve_launches``; in
    ``nee.scan_setup_launches`` too where ``nee_setup`` scans the
    primitives) around the walks, and ``nee_backward`` when the gradient is
    taken (``nee.backward_launches``; ``nee.src_backward_launches`` where it
    stores through a compaction's ``src``); CPU tensors run the plain
    versions.  Where a gradient may be taken (grad mode on and one of the
    throughput, the radiance, the albedo, the atlas texels and the
    emittance requiring grad) the call goes through :class:`NeeFunction`;
    otherwise the CUDA route launches the forward alone, with no autograd
    node and no residual.  Any other device raises, and so does a tensor other than the
    five differentiated that requires grad.  ``prim_slots=False`` (on the
    card, a scene with primitives): ``nee_setup`` writes no primitive slots
    and the walks launch K7 over every shadow ray, the route before K7 was
    folded into ``nee_setup``, kept to compare the two.  ``idx`` ((B,)
    int32, the compaction's carried lane index; a frame's last bounce on a
    scene that samples light): the radiance is returned in the lanes' own
    order, row ``i``'s at row ``idx[i]`` (counted in
    ``nee.idx_resolve_launches`` and, for the backward, in
    ``nee.idx_backward_launches``); on a scene that samples no light it
    raises, since K4 writes the radiance there (:func:`samples_light`)."""
    plan = _scene_plan(scene)
    if plan is None:
        _no_plan_for(idx)
        return out.state["radiance"]
    tp = st["throughput"]
    dev = tp.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"nee: unsupported device {dev}")
    cuda = _uses_kernels(tp)
    entry = _scene_entry(scene, plan) if cuda else None
    if entry is not None and not prim_slots:
        entry = entry._replace(prims=False)
    _check_no_other_grad(_scene_no_grad(scene) if entry is None else entry.no_grad, u, out)
    call = _Call(scene, plan, st["cur_mat"], u, out.hitpoint, out.normal, out.mat, out.diffuse_on)
    rad, albedo = out.state["radiance"], out.albedo
    atlas, emittance = _atlas_data(scene.atlas), scene.materials.emittance
    lanes = st.get("lanes")
    tp_in = tp if lanes is None else lanes.throughput
    if not cuda or (torch.is_grad_enabled() and (tp_in.requires_grad or rad.requires_grad or albedo.requires_grad
                                                 or atlas.requires_grad or emittance.requires_grad)):
        return NeeFunction.apply(tp_in, rad, albedo, atlas, emittance, call, entry,
                                 None if lanes is None else (tp, lanes), idx)
    return _forward_cuda(call, tp, rad, albedo, False, entry, idx)[0]


nee.setup_launches = 0
nee.resolve_launches = 0
nee.backward_launches = 0
nee.scan_setup_launches = 0  # of nee.setup_launches: the variant with K7's scan folded in
nee.src_backward_launches = 0  # of nee.backward_launches: storing through a compaction's src
nee.idx_resolve_launches = 0  # of nee.resolve_launches: storing the radiance at idx (the unpermute folded in)
nee.idx_backward_launches = 0  # of nee.backward_launches: reading the radiance cotangent at idx


# ---- the CUDA kernels

_rows = functools.partial(k4._rows, who="nee")
_dense = functools.partial(k4._dense, who="nee")


class _Tables(ctypes.Structure):
    """``struct NeeTables`` of ``csrc/nee.cu``."""

    _fields_ = ([(f, ctypes.c_void_p) for f in ("ior", "emittance", "flags", "texture_index", "atlas", "sizes")]
                + [("atlas_h", ctypes.c_int), ("atlas_w", ctypes.c_int)]
                + [("leaf_material", ctypes.c_void_p), ("n_leaf", ctypes.c_int), ("leaf_model", ctypes.c_void_p),
                   ("n_leaf_model", ctypes.c_int), ("face_material", ctypes.c_void_p)]
                + [(f, ctypes.c_void_p) for f in ("su", "sv", "sw", "radius_cos", "sun_emittance", "luminosity",
                                                  "e_pos", "e_size", "e_mat", "grid_idx", "grid_w")]
                + [(f, ctypes.c_int) for f in ("n_emit", "grid_k", "grid_side", "grid_vec")]
                + [(f, ctypes.c_float) for f in ("cell_offset", "inv_cell", "lam", "inv_lam", "inv_one_m_lam",
                                                 "one_m_lam", "lam_over_e")]
                + [("prims", k7._PrimTables), ("prim_t_max", ctypes.c_float)])


class _Flags(ctypes.Structure):
    """``struct NeeFlags`` of ``csrc/nee.cu``."""

    _fields_ = ([(f, ctypes.c_int) for f in ("sun", "em_mode", "faces", "strict", "sun_luminosity", "binary")]
                + [("f_sub", ctypes.c_float)])


# nee_setup's slot array (``enum SetupSlot``): the hand-off and the lane's
# state, the uniforms' row stride, then the outputs in NeeRays' order
SETUP_IN = ("hitpoint", "normal", "mat", "diffuse_on", "cur_mat", "u")
SETUP_SLOTS = SETUP_IN + ("u_stride",) + NeeRays._fields
SETUP_ARRAY = ctypes.c_void_p * len(SETUP_SLOTS)
# nee_backward's slot array (``enum BackwardSlot``)
BACKWARD_SLOTS = ("atlas", "emittance", "sun_emittance", "g_radiance", "albedo", "throughput", "resid", "scale",
                  "d_throughput", "d_albedo", "d_atlas", "d_emittance", "sum_atlas", "sum_emittance", "src", "idx",
                  "d_radiance")
BACKWARD_ARRAY = ctypes.c_void_p * len(BACKWARD_SLOTS)
# nee_resolve's slot array (``enum ResolveSlot``): the lane's inputs, the
# rays' fields it reads, the walks' records (null where the walk made none),
# the outputs, then the two row strides
RESOLVE_IN = ("albedo", "throughput", "radiance", "cur_mat")
WALK_FIELDS = ("hit", "t", "face_id", "uv", "leaf_value", "count", "mats", "uu", "vv", "ts")
RESOLVE_SLOTS = (RESOLVE_IN + ("on", "max_t", "scale", "e_texel", "e_mat") + WALK_FIELDS
                 + ("p_hit", "p_t", "p_mat", "p_uv", "idx", "out_radiance", "resid", "throughput_stride",
                    "radiance_stride"))
RESOLVE_ARRAY = ctypes.c_void_p * len(RESOLVE_SLOTS)


@functools.cache
def _library():
    """The library of ``nee_setup``, ``nee_resolve`` and ``nee_backward``,
    built at first use."""
    from ..utils.cuda_build import load_library

    # no FMA contraction: the plain versions' eager torch rounds every multiply and add
    lib = load_library("nee", ("-fmad=false",))
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nee_setup.argtypes = [ci, vp, vp, vp, ci, vp]  # b, tables, flags, slots, slot count, stream
    lib.nee_resolve.argtypes = [ci, vp, vp, vp, ci, vp]  # b, tables, flags, slots, slot count, stream
    # b, slots, slot count, texels, materials, sun, emitter mode, faces, stream
    lib.nee_backward.argtypes = [ci, vp, ci, ll, ci, ci, ci, ci, vp]
    lib.nee_backward_config.argtypes = [ci, ll, ci, ctypes.POINTER(ctypes.c_int)]
    lib.nee_resolve_config.argtypes = [ci, ctypes.POINTER(ctypes.c_int)]
    lib.nee_setup_attributes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.nee_setup, lib.nee_resolve, lib.nee_backward, lib.nee_backward_config, lib.nee_resolve_config,
               lib.nee_setup_attributes):
        fn.restype = ci
    lib.nee_error_string.argtypes = [ci]
    lib.nee_error_string.restype = ctypes.c_char_p
    return lib


class _SceneEntry(NamedTuple):
    """A light-sampling scene's tables checked and packed once for all its
    bounces, with its flags."""

    tensors: tuple  # the table tensors (the cache's key, by identity)
    settings: tuple  # the plan, the sampling settings and the emitter grid's scalars (the key, by value)
    device: torch.device
    tables: _Tables
    tables_ref: object  # ctypes.byref(tables)
    flags: _Flags
    flags_ref: object  # ctypes.byref(flags)
    no_grad: tuple  # (name, tensor) of the tables read but not differentiated
    prims: bool  # the scene has primitives: nee_setup scans each cast ray


# the newest scenes' entries, the newest last
_TABLE_CACHE: list = []
_TABLE_CACHE_SIZE = 4


def _table_tensors(scene: Scene) -> tuple:
    mod, atlas, m, sun, em = scene.models, scene.atlas, scene.materials, scene.sun, scene.emitters
    return (_atlas_data(atlas), atlas.sizes if isinstance(atlas, Atlas) else None, m.ior, m.emittance, m.flags,
            m.texture_index, scene.leaf_material, None if mod is None else mod.leaf_model,
            None if mod is None else mod.face_material, sun.su, sun.sv, sun.sw, sun.radius_cos, sun.emittance,
            sun.luminosity, *((None,) * 5 if em is None else (em.pos, em.size, em.mat, em.grid_idx, em.grid_w)),
            *k7.prim_tensors(scene.prims))


def _settings(scene: Scene, plan: NeePlan) -> tuple:
    strat, em = scene.sun_sampling, scene.emitters
    grid = None if em is None else (em.grid_bits, em.cell_size, em.lam)
    return (plan, strat.strict_direct_light, strat.sun_luminosity, scene.shadow_binary, scene.f_sub_surface, grid)


def _scene_entry(scene: Scene, plan: NeePlan) -> _SceneEntry:
    """``scene``'s :class:`_SceneEntry` under ``plan``.  The cache is keyed
    by the identity of the table tensors and the value of the sampling
    settings, and holds the tensors, so no key outlives them."""
    key = _table_tensors(scene)
    settings = _settings(scene, plan)
    for entry in reversed(_TABLE_CACHE):
        if entry.settings == settings and all(map(operator.is_, entry.tensors, key)):
            return entry
    data, sizes, ior, emit, flags, tex, leaf_material, leaf_model, face_material = key[:9]
    f32, i32 = torch.float32, torch.int32
    if data.dtype != f32 or data.dim() != 4 or data.shape[3] != 4 or not data.is_contiguous():
        raise ValueError("nee: the atlas must be a contiguous (T, H, W, 4) float32")
    if data.numel() // 4 >= 2**31 or data.data_ptr() % 16:
        raise ValueError("nee: the atlas must be 16-byte aligned with under 2^31 texels")
    if sizes is not None:
        _dense(sizes, (data.shape[0], 2), i32, "the atlas sizes")
    n_mat = ior.shape[0]
    for name, x, dt in (("ior", ior, f32), ("emittance", emit, f32), ("flags", flags, i32),
                        ("texture_index", tex, i32)):
        _dense(x, (n_mat,), dt, f"materials.{name}")
    _dense(leaf_material, (leaf_material.shape[0],), i32, "leaf_material")
    if leaf_model is not None:
        _dense(leaf_model, (leaf_model.shape[0],), i32, "models.leaf_model")
        _dense(face_material, (face_material.shape[0], 6), i32, "models.face_material")
    for name, x, shape in (("su", key[9], (3,)), ("sv", key[10], (3,)), ("sw", key[11], (3,)),
                           ("radius_cos", key[12], ()), ("emittance", key[13], (4,)), ("luminosity", key[14], ())):
        _dense(x, shape, f32, f"sun.{name}")
    em = scene.emitters
    e_cnt, grid_k, grid_side, grid_vec, consts = 0, 0, 0, 0, (0.0,) * 7
    if em is not None:
        e_cnt = em.count
        _dense(em.pos, (e_cnt, 3), f32, "emitters.pos")
        _dense(em.size, (e_cnt,), f32, "emitters.size")
        _dense(em.mat, (e_cnt,), i32, "emitters.mat")
        if e_cnt == 0:
            raise ValueError("nee: an empty emitter table")
        if em.grid_idx is not None:
            grid_side = 1 << em.grid_bits
            grid_k = em.grid_idx.shape[1]
            if not 0 < grid_k <= MAX_GRID_K:
                raise ValueError(f"nee: supercell rows of {grid_k} emitters (the kernel takes 1 to {MAX_GRID_K})")
            _dense(em.grid_idx, (grid_side ** 3, grid_k), i32, "emitters.grid_idx")
            _dense(em.grid_w, (grid_side ** 3, grid_k), f32, "emitters.grid_w")
            # the rows as 16-byte vectors where each row starts on a 16-byte boundary
            grid_vec = int(grid_k % 4 == 0 and em.grid_idx.data_ptr() % 16 == 0 and em.grid_w.data_ptr() % 16 == 0)
        # the pick's Python scalars as the card's eager torch takes them: a
        # scalar operand rounded to float, a division by one a multiply by
        # the float reciprocal
        f = np.float32
        lam, cs = f(em.lam), f(em.cell_size)
        consts = (f(0.01 * em.cell_size), f(1.0) / cs, lam, f(1.0) / lam, f(1.0) / f(1.0 - em.lam),
                  f(1.0 - em.lam), f(em.lam / e_cnt))
    dev = data.device
    if any(x is not None and x.device != dev for x in key):
        raise ValueError("nee: every input must be on the lanes' card")
    if scene.prims is not None:
        k7.check_tables(scene.prims, dev, "nee")
    tables = _Tables(
        ior.data_ptr(), emit.data_ptr(), flags.data_ptr(), tex.data_ptr(), data.data_ptr(), _ptr(sizes),
        data.shape[1], data.shape[2], leaf_material.data_ptr(), leaf_material.shape[0], _ptr(leaf_model),
        0 if leaf_model is None else leaf_model.shape[0], _ptr(face_material),
        *(x.data_ptr() for x in key[9:15]), *(_ptr(x) for x in key[15:20]), e_cnt, grid_k, grid_side, grid_vec,
        *(float(c) for c in consts), k7.prim_tables(scene.prims), MAX_DIST)
    strat = scene.sun_sampling
    fl = _Flags(int(plan.sun), EM_MODES.get(plan.emitters, 0), plan.faces, int(strat.strict_direct_light),
                int(strat.sun_luminosity), int(scene.shadow_binary), float(np.float32(scene.f_sub_surface)))
    entry = _SceneEntry(key, settings, dev, tables, ctypes.byref(tables), fl, ctypes.byref(fl),
                        _scene_no_grad(scene), k7.prim_count(scene.prims) > 0)
    _TABLE_CACHE.append(entry)
    del _TABLE_CACHE[:-_TABLE_CACHE_SIZE]
    return entry


def _launch(fn_name: str, fn, device_index: int, *args):
    rc = on_current_stream(fn, device_index, *args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: {_library().nee_error_string(rc).decode()}")


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
# nee_setup's inputs: (dtype, width: 0 for (B,), k for (B, k) dense, -k for rows of k with any row stride)
_SETUP_SPEC = ((_F32, 3), (_F32, 3), (_I32, 0), (_BOOL, 0), (_I32, 0), (_F32, -N_UNIFORMS))
# NeeRays' fields carved from one buffer (width, dtype), each on a 16-byte
# boundary, K7's hit of each ray last where the scene has primitives;
# ``scale``, which the backward saves, is an allocation of its own, so that
# saving it keeps nothing else of a bounce alive
_RAY_PARTS = (("origin", 3, _F32), ("dir", 3, _F32), ("max_t", 1, _F32), ("cur_mat", 1, _I32),
              ("e_texel", 1, _I32), ("e_mat", 1, _I32), ("active", 1, _BOOL))
_PRIM_PARTS = (("p_t", 1, _F32), ("p_uv", 2, _F32), ("p_mat", 1, _I32), ("p_hit", 1, _BOOL))
_DTYPE_INDEX = {_F32: 0, _I32: 1, _BOOL: 2}


@functools.lru_cache(maxsize=256)
def _expected_setup(b: int) -> tuple:
    """The (dtype, shape) of ``nee_setup``'s inputs for ``b`` lanes."""
    return tuple((dt, torch.Size((b,) if w == 0 else (b, abs(w)))) for dt, w in _SETUP_SPEC)


@functools.lru_cache(maxsize=256)
def _ray_layout(fb: int, prims: bool = False) -> tuple:
    """(bytes, {field: (element offset in its dtype, shape, stride, dtype
    index, byte offset)}) of NeeRays' carved fields for ``fb`` rays, with
    K7's hit where ``prims``."""
    parts, end = {}, 0
    for name, width, dt in _RAY_PARTS + (_PRIM_PARTS if prims else ()):
        shape, stride = ((fb, width), (width, 1)) if width > 1 else ((fb,), (1,))
        parts[name] = (end // dt.itemsize, shape, stride, _DTYPE_INDEX[dt], end)
        end = (end + fb * width * dt.itemsize + 15) // 16 * 16
    return max(end, 16), parts


def _checked_setup_inputs(call: _Call, b: int, dev) -> tuple:
    """``nee_setup``'s inputs checked in one pass (dtype, shape, dense
    columns and rows with a dense last axis, the lanes' card); the
    uniforms copied dense where their last axis is strided.  A wrong input
    raises naming it."""
    ins = (call.hitpoint, call.normal, call.mat, call.diffuse_on, call.cur_mat, call.u)
    if (tuple((x.dtype, x.shape) for x in ins) == _expected_setup(b)
            and all(x.is_contiguous() for x in ins[:5]) and ins[5].stride(-1) == 1
            and all(x.device == dev for x in ins)):
        return ins
    checked = []
    for x, (dt, w), name in zip(ins, _SETUP_SPEC, SETUP_IN):
        y = _rows(x, b, -w, dt, "the uniforms") if w < 0 else _dense(x, (b,) if w == 0 else (b, w), dt, name)
        if y.device != dev:
            raise ValueError("nee: every input must be on the lanes' card")
        checked.append(y)
    return tuple(checked)


def _setup_cuda(call: _Call, entry: _SceneEntry | None = None) -> NeeRays:
    """``nee_setup`` on the card: the scene's cached entry (looked up where
    not given), the inputs checked in one pass, the rays one allocation
    (with K7's hit of each ray where the scene has primitives) and
    ``scale`` another, one entry-point call."""
    b = call.cur_mat.shape[0]
    fb = call.plan.faces * b
    dev = call.cur_mat.device
    if fb >= 2**31:
        raise ValueError("nee: too many shadow rays for one launch")
    entry = _scene_entry(call.scene, call.plan) if entry is None else entry
    if entry.device != dev:
        raise ValueError("nee: every input must be on the lanes' card")
    ins = _checked_setup_inputs(call, b, dev)
    n_bytes, parts = _ray_layout(fb, entry.prims)
    buf = torch.empty(n_bytes, dtype=torch.uint8, device=dev)
    scale = torch.empty((fb,), dtype=_F32, device=dev)
    typed = (buf.view(_F32), buf.view(_I32), buf.view(_BOOL))
    rays = NeeRays._make(scale if f == "scale" else typed[parts[f][3]].as_strided(*parts[f][1:3], parts[f][0])
                         if f in parts else None for f in NeeRays._fields)
    if b == 0:  # an empty batch launches nothing
        return rays
    base = buf.data_ptr()
    slots = SETUP_ARRAY(*(x.data_ptr() for x in ins), ins[5].stride(0),
                        *(scale.data_ptr() if f == "scale" else base + parts[f][4] if f in parts else None
                          for f in NeeRays._fields))
    _launch("nee_setup", _library().nee_setup, dev.index, b, entry.tables_ref, entry.flags_ref, slots,
            len(SETUP_SLOTS))
    nee.setup_launches += 1
    nee.scan_setup_launches += entry.prims
    return rays


# nee_resolve's lane inputs: (dtype, width: 0 for (B,), k for (B, k) dense, -k for rows of k with any row stride)
_RESOLVE_SPEC = ((_F32, 4), (_F32, -3), (_F32, -3), (_I32, 0))


@functools.lru_cache(maxsize=256)
def _expected_resolve(b: int) -> tuple:
    """The (dtype, shape) of ``nee_resolve``'s lane inputs for ``b`` lanes."""
    return tuple((dt, torch.Size((b,) if w == 0 else (b, abs(w)))) for dt, w in _RESOLVE_SPEC)


def _checked_resolve_inputs(ins: tuple, b: int, dev) -> tuple:
    """``nee_resolve``'s lane inputs (albedo, throughput, radiance, cur_mat)
    checked in one pass (dtype, shape, the albedo's dense 16-byte rows, the
    rows' dense last axis, the lanes' card); a row input whose last axis is
    strided is copied dense.  A wrong input raises naming it."""
    if (tuple((x.dtype, x.shape) for x in ins) == _expected_resolve(b)
            and ins[0].is_contiguous() and ins[0].data_ptr() % 16 == 0 and ins[3].is_contiguous()
            and ins[1].stride(-1) == 1 and ins[2].stride(-1) == 1 and all(x.device == dev for x in ins)):
        return ins
    checked = []
    for x, (dt, w), name in zip(ins, _RESOLVE_SPEC, RESOLVE_IN):
        y = _rows(x, b, -w, dt, name) if w < 0 else _dense(x, (b,) if w == 0 else (b, w), dt, name)
        if y.device != dev:
            raise ValueError("nee: every input must be on the lanes' card")
        checked.append(y)
    if checked[0].data_ptr() % 16:
        raise ValueError("nee: the albedo rows must be 16-byte aligned")
    return tuple(checked)


def _resolve_cuda(call: _Call, rays: NeeRays, walk, prim, throughput, radiance, albedo, want_grad: bool,
                  entry: _SceneEntry | None = None, idx=None):
    """``nee_resolve`` on the card over the walks' records: (radiance (B, 3),
    :class:`NeeResidual` or None).  The scene's cached entry, the inputs
    checked in one pass, one allocation each for the radiance and the
    residual, one entry-point call; the radiance of row ``i`` stored at row
    ``idx[i]`` where ``idx`` is given (a frame's last bounce)."""
    plan = call.plan
    b = throughput.shape[0]
    dev = throughput.device
    entry = _scene_entry(call.scene, plan) if entry is None else entry
    if entry.device != dev or rays.active.device != dev:
        raise ValueError("nee: every input must be on the lanes' card")
    alb, tp, rad, cur_mat = _checked_resolve_inputs((albedo, throughput, radiance, call.cur_mat), b, dev)
    if idx is not None:
        idx = _dense(idx, (b,), _I32, "idx")
        if idx.device != dev:
            raise ValueError("nee: every input must be on the lanes' card")
    out = torch.empty((b, 3), dtype=_F32, device=dev)
    resid = None
    if want_grad:
        resid = NeeResidual(torch.empty((plan.faces, b, RESID_INTS), dtype=_I32, device=dev),
                            rays.scale.view(plan.faces, b))
    if b == 0:  # an empty batch launches nothing
        return out, resid
    if hasattr(walk, "mats"):
        w_ptrs = (None,) * 5 + tuple(_ptr(x) for x in (walk.count, walk.mats, walk.uu, walk.vv, walk.ts))
    else:
        w_ptrs = tuple(_ptr(x) for x in (walk.hit, walk.t, walk.face_id, walk.uv, walk.leaf_value)) + (None,) * 5
    p_ptrs = (None,) * 4 if prim is None else tuple(_ptr(x) for x in prim[:4])
    slots = RESOLVE_ARRAY(alb.data_ptr(), tp.data_ptr(), rad.data_ptr(), cur_mat.data_ptr(), rays.active.data_ptr(),
                          rays.max_t.data_ptr(), rays.scale.data_ptr(), rays.e_texel.data_ptr(),
                          rays.e_mat.data_ptr(), *w_ptrs, *p_ptrs, _ptr(idx), out.data_ptr(),
                          None if resid is None else resid.ints.data_ptr(), tp.stride(0), rad.stride(0))
    _launch("nee_resolve", _library().nee_resolve, dev.index, b, entry.tables_ref, entry.flags_ref, slots,
            len(RESOLVE_SLOTS))
    nee.resolve_launches += 1
    nee.idx_resolve_launches += idx is not None
    return out, resid


def _forward_cuda(call: _Call, throughput, radiance, albedo, want_grad: bool, entry: _SceneEntry | None = None,
                  idx=None):
    """The forward on the card: ``nee_setup``, the walks, ``nee_resolve``
    (storing the radiance through ``idx`` where given), the scene's entry
    looked up once."""
    entry = _scene_entry(call.scene, call.plan) if entry is None else entry
    rays = _setup_cuda(call, entry)
    walk, prim = nee_walks(call.scene, call.plan, rays)
    return _resolve_cuda(call, rays, walk, prim, throughput, radiance, albedo, want_grad, entry, idx)


# per card: the backward's float64 sums (the atlas's entries, then the
# emittance's), zero when allocated, the newest last; the kernel leaves
# what it summed zero again.  A buffer outgrown stays allocated: a CUDA
# graph captured with it replays against it.
_SCRATCH: dict = {}


def _scratch(dev, words: int):
    """The float64 scratch of card ``dev`` for ``words`` sums: calls on one
    card share it, and so must run on one stream, one after another.  It
    grows outside a CUDA graph capture only (a capture would record the
    fill and leave the buffer unset until a replay); a capture needs one
    eager call of at least its size first."""
    bufs = _SCRATCH.setdefault(dev.index, [])
    if not bufs or bufs[-1].numel() < words:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("nee: the backward's scratch must be allocated before a CUDA graph capture; run one "
                               "backward of this scene outside the capture first")
        bufs.append(torch.zeros(max(words, 4096), dtype=torch.float64, device=dev))
    return bufs[-1]


def _backward_cuda(albedo, throughput, resid: NeeResidual, atlas, emittance, sun_emittance, plan: NeePlan,
                   g_radiance, need, src=None, idx=None):
    """``nee_backward`` on the card: one launch that sums the atlas and
    emittance gradients in the card's float64 scratch and writes them
    dense in float32 (no fill, no conversion); the lane gradients one
    allocation, the table gradients another.  ``src`` ((B,) int32, after a
    compaction): the throughput's gradient of lane ``i`` is stored at row
    ``src[i]``, the rows from before the compaction (every row written).
    ``idx`` ((B,) int32, a frame's last bounce): lane ``i``'s radiance
    cotangent is read at row ``idx[i]``, and the radiance's gradient is that
    cotangent in row order, written by the kernel (a third part of the lane
    gradients' allocation)."""
    b = albedo.shape[0]
    dev = albedo.device
    g = _dense(g_radiance if g_radiance.is_contiguous() else g_radiance.contiguous(), (b, 3), _F32,
               "the radiance cotangent")
    tp = throughput if throughput.is_contiguous() else throughput.contiguous()
    moves_rad = idx is not None and need[1]
    lanes = torch.empty((7 * b if need[0] or need[2] else 0) + (3 * b if moves_rad else 0), dtype=_F32, device=dev)
    d_tp = lanes.as_strided((b, 3), (3, 1), 4 * b) if need[0] else None
    d_alb = lanes.as_strided((b, 4), (4, 1), 0) if need[2] else None
    d_rad = (lanes.as_strided((b, 3), (3, 1), 7 * b if need[0] or need[2] else 0) if moves_rad
             else g_radiance if need[1] else None)
    n_atlas, n_emit = atlas.numel(), emittance.numel()
    d_atlas = d_emit = None
    sums = (None, None)
    if need[3] or need[4]:
        tables = torch.empty((n_atlas if need[3] else 0) + (n_emit if need[4] else 0), dtype=_F32, device=dev)
        if need[3]:
            d_atlas = tables.as_strided(atlas.shape, atlas.stride(), 0)
        if need[4]:
            d_emit = tables.as_strided(emittance.shape, (1,), n_atlas if need[3] else 0)
        scratch = _scratch(dev, n_atlas + n_emit)
        base = scratch.data_ptr()
        sums = (base if need[3] else None, base + 8 * n_atlas if need[4] else None)
    if (any(need[i] for i in (0, 2, 3, 4)) or moves_rad) and (b > 0 or d_atlas is not None or d_emit is not None):
        slots = BACKWARD_ARRAY(atlas.data_ptr(), emittance.data_ptr(), sun_emittance.data_ptr(), g.data_ptr(),
                               albedo.data_ptr(), tp.data_ptr(), resid.ints.data_ptr(), resid.scale.data_ptr(),
                               _ptr(d_tp), _ptr(d_alb), _ptr(d_atlas), _ptr(d_emit), *sums, _ptr(src), _ptr(idx),
                               _ptr(d_rad) if moves_rad else None)
        _launch("nee_backward", _library().nee_backward, dev.index, b, slots, len(BACKWARD_SLOTS), n_atlas // 4,
                n_emit, int(plan.sun), EM_MODES.get(plan.emitters, 0), plan.faces)
        nee.backward_launches += 1
        nee.src_backward_launches += src is not None
        nee.idx_backward_launches += idx is not None
    return d_tp, d_rad, d_alb, d_atlas, d_emit


def backward_config(b: int, atlas_shape, n_emit: int, device=None) -> dict:
    """How ``nee_backward`` launches on ``b`` lanes with a (T, H, W, 4)
    atlas gradient and ``n_emit`` materials on the current card (or
    ``device``): {"threads", "blocks", "resident_blocks_per_sm", "sms",
    "launch": "cooperative"}."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    n_texels = math.prod(atlas_shape[:3])
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        rc = lib.nee_backward_config(b, n_texels, n_emit, out)
    if rc != 0:
        raise RuntimeError(f"nee_backward launch configuration failed: {lib.nee_error_string(rc).decode()}")
    return dict(zip(("threads", "blocks", "resident_blocks_per_sm", "sms"), out[:4]), launch="cooperative")


def setup_attributes(device=None) -> dict:
    """``nee_setup``'s registers per thread and stack frame bytes on the
    current card (or ``device``), without and with K7's scan folded in:
    {"plain": {"registers", "stack_bytes"}, "scan": {...}}."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        rc = lib.nee_setup_attributes(out)
    if rc != 0:
        raise RuntimeError(f"nee_setup attributes failed: {lib.nee_error_string(rc).decode()}")
    return {"plain": {"registers": out[0], "stack_bytes": out[1]}, "scan": {"registers": out[2], "stack_bytes": out[3]}}


def resolve_config(b: int, device=None) -> dict:
    """How ``nee_resolve`` launches on ``b`` lanes on the current card (or
    ``device``): {"threads", "blocks", "registers" (per thread),
    "resident_blocks_per_sm"}."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        rc = lib.nee_resolve_config(b, out)
    if rc != 0:
        raise RuntimeError(f"nee_resolve launch configuration failed: {lib.nee_error_string(rc).decode()}")
    return dict(zip(("threads", "blocks", "registers", "resident_blocks_per_sm"), out))
