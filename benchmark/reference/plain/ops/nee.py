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
from . import compact as k5
from . import shade as k4
from .shade import _atlas_data, resolve_hit
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
