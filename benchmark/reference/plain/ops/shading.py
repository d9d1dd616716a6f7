"""BRDF sampling building blocks (port of ``ops/shading.py``).

Every sampler reads its uniforms from fixed slots of a pre-drawn
``(B, N_UNIFORMS)`` block, so a render is reproducible from the block alone
and the tests can feed the JAX package and this port the same numbers.

Uniform slot map (per lane, per bounce):

====  =======================================
slot  use
====  =======================================
0     metal lobe choice
1     specular lobe choice
2     diffuse lobe choice
3     Fresnel reflect choice
4,5   x1, x2 — cosine/perturbation sample
6     sun importance-sample chance
7     subsurface-scatter chance
8-15  4 redraw pairs (shallow-angle rejection)
16,17 sun-cone NEE sample
18    emitter pick (EmitterSampling.ONE)
19,20 emitter surface-point sample
====  =======================================
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.camera import _cross, _normalize
from ..models.sun import MAX_IMPORTANCE_SAMPLE_CHANCE, Sun

PI = np.pi
EPSILON = 5e-8  # Ray::EPSILON
OFFSET = 1e-6  # Ray::OFFSET

N_UNIFORMS = 21
U_METAL, U_SPECULAR, U_DIFFUSE, U_FRESNEL = 0, 1, 2, 3
U_X1, U_X2 = 4, 5
U_IMPORTANCE, U_SUBSURFACE = 6, 7
U_REDRAW0 = 8  # 4 pairs: 8..15
U_SUN1, U_SUN2 = 16, 17
U_EM_PICK, U_EM1, U_EM2 = 18, 19, 20


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _helper_axis(n):
    """(0,1,0) where |n.x| > 0.1, else (1,0,0): the frame's helper vector."""
    big_x = (torch.abs(n[:, 0]) > 0.1)[:, None]
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    return torch.where(big_x, y_axis[None], x_axis[None])


def tangent_frame_spec(n):
    """Frame of specular/scatter sampling: u = normalize(t x n), v = n x u."""
    u = _normalize(_cross(_helper_axis(n), n))
    return u, _cross(n, u)


def tangent_frame_diffuse(n):
    """Frame of diffuse reflection: u = normalize(x x n), v = u x n."""
    u = _normalize(_cross(_helper_axis(n), n))
    return u, _cross(u, n)


def _opposite_side_correction(new_dir, n, d_in):
    """Nudge ``new_dir`` to the opposite side of ``n`` from ``d_in``."""
    same = torch.sign(_dot(n, new_dir)) == torch.sign(_dot(n, d_in))
    factor = torch.sign(_dot(n, d_in)) * (-EPSILON) - _dot(new_dir, n)
    fixed = _normalize(new_dir + factor[:, None] * n)
    return torch.where(same[:, None], fixed, new_dir)


def specular_reflect_dir(d_in, n, roughness, u):
    """Mirror direction lerped with a cosine-lobe perturbation by roughness.
    Returns unit directions."""
    mirror = d_in - 2.0 * _dot(d_in, n)[:, None] * n
    x1 = u[:, U_X1]
    x2 = u[:, U_X2]
    r = torch.sqrt(x1)
    theta = 2.0 * PI * x2
    tx, ty, tz = r * torch.cos(theta), r * torch.sin(theta), torch.sqrt(1.0 - x1)
    tu, tv = tangent_frame_spec(n)
    lobe = tu * tx[:, None] + tv * ty[:, None] + n * tz[:, None]
    rough = roughness[:, None]
    blended = _normalize(lobe * rough + mirror * (1.0 - rough))
    out = torch.where(roughness[:, None] > EPSILON, blended, mirror)
    return _opposite_side_correction(out, n, d_in)


def _ang_dist(a, b):
    diff = torch.abs(a - b) % (2.0 * PI)
    return torch.where(diff > PI, 2.0 * PI - diff, diff)


def diffuse_dir_and_weight(n, sun: Sun, u, importance_sampling: bool):
    """Cosine-hemisphere sample, optionally warped toward the sun cap with a
    throughput reweight.  Returns (dir (B, 3), weight (B,)); the weight
    multiplies the lane's albedo/throughput (1 where no warp applies)."""
    x1 = u[:, U_X1]
    x2 = u[:, U_X2]
    r = torch.sqrt(x1)
    theta = 2.0 * PI * x2
    tx = r * torch.cos(theta)
    ty = r * torch.sin(theta)
    weight = torch.ones_like(x1)

    if importance_sampling:
        sun_alt_f = sun.altitude
        sun_alt = torch.where(
            torch.abs(sun_alt_f) > PI / 2.0, torch.sign(sun_alt_f) * PI - sun_alt_f, sun_alt_f
        )
        sun_az = sun.azimuth
        sdx = torch.cos(sun_az) * torch.cos(sun_alt)
        sdy = torch.sin(sun_alt)
        sdz = torch.sin(sun_az) * torch.cos(sun_alt)
        nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
        sun_tz = sdx * nx + sdy * ny + sdz * nz
        big_x = torch.abs(nx) > 0.1
        sun_tx = torch.where(big_x, sdx * nz - sdz * nx, sdz * ny - sdy * nz)
        sun_ty = torch.where(
            big_x,
            sdx * nx * ny - sdy * (nx * nx + nz * nz) + sdz * ny * nz,
            sdy * nx * ny - sdx * (ny * ny + nz * nz) + sdz * nx * nz,
        )
        hyp = torch.where(big_x, torch.hypot(nx, nz), torch.hypot(nz, ny))
        sun_tx = sun_tx / hyp
        sun_ty = sun_ty / hyp

        cr = sun.radius * sun.importance_sample_radius
        chance = sun.importance_sample_chance
        sun_alt_rel = torch.asin(torch.clamp(sun_tz, -1.0, 1.0))
        visible = sun_alt_rel + cr > EPSILON
        cap_inside = torch.hypot(sun_tx, sun_ty) + cr + EPSILON < 1.0

        # circular-cap case
        take_cap = u[:, U_IMPORTANCE] < chance
        cap_tx = sun_tx + tx * cr
        cap_ty = sun_ty + ty * cr
        cap_w = cr * cr / chance
        # deterministic remap out of the cap (bounded fixpoint)
        otx, oty = tx, ty
        for _ in range(8):
            inside = torch.hypot(otx - sun_tx, oty - sun_ty) < cr
            ntx = (otx - sun_tx) / cr
            nty = (oty - sun_ty) / cr
            otx = torch.where(inside, ntx, otx)
            oty = torch.where(inside, nty, oty)
        out_w = (1.0 - cr * cr) / (1.0 - chance)

        cap_sel_tx = torch.where(take_cap, cap_tx, otx)
        cap_sel_ty = torch.where(take_cap, cap_ty, oty)
        cap_sel_w = torch.where(take_cap, cap_w, out_w)

        # shallow-angle annular segment
        min_r = torch.cos(sun_alt_rel + cr)
        max_r = torch.cos(torch.clamp(sun_alt_rel - cr, min=0.0))
        sun_theta = torch.atan2(sun_ty, sun_tx)
        seg = ((max_r * max_r - min_r * min_r) * cr) / PI
        s_chance = torch.clamp(chance * seg / (cr * cr), max=MAX_IMPORTANCE_SAMPLE_CHANCE)
        take_seg = u[:, U_IMPORTANCE] < s_chance
        seg_r = torch.sqrt(min_r * min_r * x1 + max_r * max_r * (1.0 - x1))
        seg_theta = sun_theta + (2.0 * x2 - 1.0) * cr
        seg_tx = seg_r * torch.cos(seg_theta)
        seg_ty = seg_r * torch.sin(seg_theta)
        seg_w = seg / s_chance
        # rejection with fresh redraw pairs
        rr, rtheta = r, theta
        for k in range(4):
            bad = (rr > min_r) & (rr < max_r) & (_ang_dist(rtheta, sun_theta) < cr)
            nx1 = u[:, U_REDRAW0 + 2 * k]
            nx2 = u[:, U_REDRAW0 + 2 * k + 1]
            rr = torch.where(bad, torch.sqrt(nx1), rr)
            rtheta = torch.where(bad, 2.0 * PI * nx2, rtheta)
        rej_tx = rr * torch.cos(rtheta)
        rej_ty = rr * torch.sin(rtheta)
        rej_w = (1.0 - seg) / (1.0 - s_chance)

        seg_sel_tx = torch.where(take_seg, seg_tx, rej_tx)
        seg_sel_ty = torch.where(take_seg, seg_ty, rej_ty)
        seg_sel_w = torch.where(take_seg, seg_w, rej_w)

        w_tx = torch.where(cap_inside, cap_sel_tx, seg_sel_tx)
        w_ty = torch.where(cap_inside, cap_sel_ty, seg_sel_ty)
        w_w = torch.where(cap_inside, cap_sel_w, seg_sel_w)

        tx = torch.where(visible, w_tx, tx)
        ty = torch.where(visible, w_ty, ty)
        weight = torch.where(visible, w_w, weight)

    tz = torch.sqrt(torch.clamp(1.0 - tx * tx - ty * ty, min=0.0))
    tu, tv = tangent_frame_diffuse(n)
    d = tu * tx[:, None] + tv * ty[:, None] + n * tz[:, None]
    return d, weight


def refract_dir(d_in, n, ior_ratio, cos_theta, radicand):
    """Snell refraction direction."""
    t2 = torch.sqrt(torch.clamp(radicand, min=0.0))
    pos = ior_ratio[:, None] * d_in + (ior_ratio * cos_theta - t2)[:, None] * n
    neg = ior_ratio[:, None] * d_in - (-ior_ratio * cos_theta - t2)[:, None] * n
    out = _normalize(torch.where(cos_theta[:, None] > 0.0, pos, neg))
    return _opposite_side_correction(out, n, d_in)


def fresnel_schlick(ior1, ior2, cos_theta):
    """Schlick reflectance."""
    ratio = ior1 / ior2
    a = ratio - 1.0
    b = ratio + 1.0
    r0 = (a * a) / (b * b)
    c = 1.0 - cos_theta
    c2 = c * c
    return r0 + (1.0 - r0) * (c * (c2 * c2))  # c**5 as XLA's integer_pow expands it
