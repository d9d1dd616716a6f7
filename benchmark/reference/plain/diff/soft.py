"""Relaxed-visibility differentiable rendering (port of ``diff/soft.py``).

The path tracer detaches the traversal, so a texel alpha that decides
whether a voxel face exists at all gets zero gradient there.  Here one
recording traversal (kernel K3r, :func:`ops.traversal.traverse_record`)
finds the first ``K_SURFACES`` surfaces along each ray, and the radiance is
recomputed differentiably as front-to-back alpha compositing

    L = sum_i  alpha_i * prod_{j<i} (1 - alpha_j) * L_i
      + prod_j (1 - alpha_j) * L_sky

where every ``alpha_i`` and ``L_i`` is a live function of the atlas and the
emittance.  ``L_i`` is the integrator's shading truncated at one diffuse
bounce whose secondary ray is assumed to escape to the sky.
"""

from __future__ import annotations

import torch

from ..models.scene import MAX_DIST, Scene, face_normals
from ..models.sun import add_sun_color, add_sun_color_diffuse, random_sun_direction, sky_color
from ..ops.shading import N_UNIFORMS, U_SUN1, U_SUN2, diffuse_dir_and_weight
from ..ops.traversal import K_SURFACES, SurfaceRecord, traverse_record
from ..render.hit import accept_tables
from ..ops.nee import _albedo_at as _albedo_uv


def record_surfaces(scene: Scene, origins, dirs) -> SurfaceRecord:
    """Detached traversal recording the first ``K_SURFACES`` surfaces per
    ray (structure only: the caller re-gathers everything that carries a
    gradient from the live scene)."""
    _, rec = traverse_record(
        scene.nodes, scene.root, scene.depth, scene.octree_scale,
        origins.detach().contiguous(), dirs.detach().contiguous(),
        accept_tables(scene), MAX_DIST,
    )
    return rec


def _surface_radiance(scene: Scene, mats, uv, face, u):
    """Per-surface radiance under the integrator's shading model truncated
    at one diffuse bounce with the secondary ray assumed to escape: emitted
    (``albedo^2 * emittance``) + ``albedo * diff_w * sky_diffuse(diff_dir)``,
    plus the unoccluded sun-NEE term when the strategy samples the sun.
    Returns (radiance (B, 3), alpha (B,)), differentiable in the atlas and
    the emittance."""
    strat = scene.sun_sampling
    albedo = _albedo_uv(scene, mats, uv[:, 0], uv[:, 1])[0]
    n = face_normals(albedo.device)[torch.clamp(face.long(), 0, 5)]
    emit = scene.materials.emittance[mats.long()]
    emitted = albedo[:, :3] * albedo[:, :3] * emit[:, None]
    diff_dir, diff_w = diffuse_dir_and_weight(n, scene.sun, u, strat.importance_sampling)
    sky = sky_color((albedo.shape[0],), albedo.device)
    if strat.diffuse_sun:
        sec = add_sun_color_diffuse(scene.sun, diff_dir, sky)[:, :3]
    else:
        sec = sky[:, :3]
    lit = albedo[:, :3] * diff_w[:, None] * sec
    if strat.sun_sampling:
        sun_dir = random_sun_direction(scene.sun, u[:, U_SUN1], u[:, U_SUN2])
        cosns = torch.sum(sun_dir * n, dim=-1)
        lum = scene.sun.luminosity_pdf if strat.sun_luminosity else 1.0
        nee = albedo[:, :3] * (torch.abs(cosns) * lum)[:, None] * scene.sun.emittance[None, :3]
        lit = lit + torch.where((cosns > 0.0)[:, None], nee, 0.0)
    return emitted + lit, albedo[:, 3]


def soft_radiance(scene: Scene, origins, dirs, u=None):
    """Alpha-composited radiance over the first ``K_SURFACES`` surfaces,
    differentiable through visibility.  Returns (B, 3) linear radiance.

    ``u``: a (B, N_UNIFORMS) uniform row driving the secondary diffuse
    sample (the integrator's first-bounce row pairs it with the hard pass);
    a deterministic mid-cell draw when None.  At binary alphas it equals the
    hard 2-bounce render wherever the secondary ray escapes."""
    rec = record_surfaces(scene, origins, dirs)
    b = origins.shape[0]
    dev = origins.device
    if u is None:
        u = torch.full((b, N_UNIFORMS), 0.5, dtype=torch.float32, device=dev)
    radiance = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    transmittance = torch.ones((b,), dtype=torch.float32, device=dev)
    for i in range(K_SURFACES):
        uv = torch.stack([rec.uu[i], rec.vv[i]], dim=-1)
        l_i, alpha_i = _surface_radiance(scene, rec.mats[i], uv, rec.face[i], u)
        live = i < rec.count
        w = torch.where(live, transmittance * alpha_i, 0.0)
        radiance = radiance + w[:, None] * l_i
        transmittance = torch.where(live, transmittance * (1.0 - alpha_i), transmittance)
    sky_rgb = add_sun_color(scene.sun, dirs, sky_color((b,), dev))[:, :3]
    return radiance + transmittance[:, None] * sky_rgb


