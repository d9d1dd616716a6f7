"""Inverse rendering — optimize voxel albedo and emission from reference
views (port of ``diff/inverse.py``).

Given target renders from several camera views, recover the texture-atlas
albedo and the per-material emittance by gradient descent through the
differentiable path tracer (detached traversal, differentiable shading),
optionally mixed with the relaxed-visibility term of :mod:`.soft`, which
carries the silhouette gradient.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..models.camera import Camera, pixel_grid_rays
from ..models.scene import Scene
from ..ops.shading import N_UNIFORMS
from ..ops.texture import Atlas
from ..parallel.shard import apply_params
from ..render.pathtracer import MAX_BOUNCES, draw_uniforms, trace_paths
from .soft import soft_radiance


def render_views(scene: Scene, cameras: list[Camera], width: int, height: int, seed: int = 0):
    """One sample per pixel of each view, view ``i`` from Philox stream
    ``i`` under ``seed``; returns (V, H*W, 3) radiance."""
    outs = []
    for i, cam in enumerate(cameras):
        origins, dirs = pixel_grid_rays(cam.to(scene.device), width, height)
        u = draw_uniforms(seed, i, origins.shape[0], MAX_BOUNCES, scene.device)
        outs.append(trace_paths(scene, origins, dirs, u))
    return torch.stack(outs)


@dataclasses.dataclass
class InverseResult:
    params: dict
    losses: list
    step_seconds: list  # host wall time of each step, ending in the loss's read-back


def make_inverse_loss(soft_weight: float = 0.25):
    """The inverse-rendering objective: path-traced photometric MSE, plus
    ``soft_weight`` x the relaxed-visibility MSE of :func:`soft_radiance`
    (which pairs its secondary diffuse sample with the hard pass's
    first-bounce uniform row).

    The returned ``loss(scene, params, all_origins, all_dirs, all_u,
    targets)`` takes (V, B, 3) rays, the (V, B, n_bounces, N_UNIFORMS)
    uniform block and (V, B, 3) targets, traces all V*B lanes at once and
    returns the mean over views of each view's mean squared error."""

    def loss_all_views(scene: Scene, params: dict, all_origins, all_dirs, all_u, targets):
        sp = apply_params(scene, params)
        v, b = all_origins.shape[:2]

        def flat(x):
            return x.reshape((v * b,) + tuple(x.shape[2:]))

        origins, dirs, u = flat(all_origins), flat(all_dirs), flat(all_u)
        rad = trace_paths(sp, origins, dirs, u).reshape(v, b, 3)
        loss = torch.mean((rad - targets) ** 2, dim=(1, 2))
        if soft_weight > 0.0:
            soft = soft_radiance(sp, origins, dirs, u=u[:, 0, :]).reshape(v, b, 3)
            loss = loss + soft_weight * torch.mean((soft - targets) ** 2, dim=(1, 2))
        return torch.mean(loss)

    return loss_all_views


def inverse_render(
    scene: Scene,
    cameras: list[Camera],
    targets,
    width: int,
    height: int,
    steps: int = 100,
    lr: float = 5e-2,
    seed: int = 0,
    init_params: dict | None = None,
    soft_weight: float = 0.25,
) -> InverseResult:
    """Optimize (atlas, emittance) with Adam (optax's defaults: betas 0.9,
    0.999, eps 1e-8) to match ``targets`` (V, H*W, 3).

    Step ``s`` draws a fresh uniform block for all views from Philox
    stream ``(s + 1) << 32`` under ``seed`` (disjoint from
    :func:`render_views`' streams), so the gradients are stochastic over
    light paths.  After each step the albedo is clamped to [0, 1] and the
    emittance to >= 0.  ``init_params`` defaults to a grey albedo with the
    scene's own alphas and no emission."""
    dev = scene.device
    if init_params is None:
        tex = scene.atlas.data if isinstance(scene.atlas, Atlas) else scene.atlas
        atlas = torch.full_like(tex, 0.5)
        atlas[..., 3] = tex[..., 3]
        init_params = {"atlas": atlas, "emittance": torch.zeros_like(scene.materials.emittance)}
    params = {k: v.detach().to(dev).clone().requires_grad_(True) for k, v in init_params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    rays = [pixel_grid_rays(cam.to(dev), width, height) for cam in cameras]
    all_origins = torch.stack([r[0] for r in rays])
    all_dirs = torch.stack([r[1] for r in rays])
    n_views, n_lanes = all_origins.shape[:2]
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    loss_fn = make_inverse_loss(soft_weight)

    losses, step_seconds = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        all_u = draw_uniforms(seed, (step + 1) << 32, n_views * n_lanes, MAX_BOUNCES, dev)
        all_u = all_u.reshape(n_views, n_lanes, MAX_BOUNCES, N_UNIFORMS)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(scene, params, all_origins, all_dirs, all_u, targets)
        loss.backward()
        opt.step()
        with torch.no_grad():  # keep albedo physical
            params["atlas"].clamp_(0.0, 1.0)
            params["emittance"].clamp_(min=0.0)
        losses.append(float(loss.detach()))
        step_seconds.append(time.perf_counter() - t0)
    return InverseResult(
        params={k: v.detach() for k, v in params.items()}, losses=losses, step_seconds=step_seconds
    )
