"""Inverse rendering's first steps, worked out again: the targets from the
true scene, then Adam from the grey start on the photometric loss plus the
relaxed-visibility term, every step's uniforms from its Philox stream.

The loss is the mean over views of each view's mean squared error (the
path-traced radiance's, plus ``soft_weight`` times the soft radiance's),
differentiated by autograd through the plain shading; Adam is written out
(betas 0.9 / 0.999, eps 1e-8), and after each step the albedo is clamped to
[0, 1] and the emittance to >= 0.  Views go through in blocks, each
block's share of the loss differentiated on its own, so the reference fits
on the card beside nothing else.
"""

from __future__ import annotations

import dataclasses

import torch

from .paths import philox_at
from .plain.diff.soft import soft_radiance
from .plain.models.camera import pixel_grid_rays
from .plain.ops.shading import N_UNIFORMS
from .plain.ops.texture import Atlas
from .plain.render.pathtracer import trace_paths

BETAS, EPS = (0.9, 0.999), 1e-8


def _uniforms(seed: int, stream: int, first_lane: int, lanes: int, n_bounces: int, dev):
    words = n_bounces * N_UNIFORMS
    idx = torch.arange(first_lane * words, (first_lane + lanes) * words, device=dev, dtype=torch.int64)
    return philox_at(seed, stream, idx, dev).reshape(lanes, n_bounces, N_UNIFORMS)


def with_params(scene, params: dict):
    atlas = Atlas(params["atlas"], scene.atlas.sizes) if isinstance(scene.atlas, Atlas) else params["atlas"]
    return dataclasses.replace(scene, atlas=atlas,
                               materials=dataclasses.replace(scene.materials, emittance=params["emittance"]))


def targets(scene, cams, width: int, height: int, seed: int, n_bounces: int, views_per_block: int,
            round_state=None):
    """One sample per pixel of each view, view ``i`` from stream ``i``,
    ``views_per_block`` views traced together."""
    out = []
    with torch.no_grad():
        for v0 in range(0, len(cams), views_per_block):
            rays = [pixel_grid_rays(c, width, height) for c in cams[v0:v0 + views_per_block]]
            n = rays[0][0].shape[0]
            u = torch.cat([_uniforms(seed, v0 + i, 0, n, n_bounces, rays[0][0].device) for i in range(len(rays))])
            rad = trace_paths(scene, torch.cat([r[0] for r in rays]), torch.cat([r[1] for r in rays]), u, round_state)
            out.extend(rad.reshape(len(rays), n, 3))
    return out


def train_steps(scene, cams, width: int, height: int, seed: int, steps: int, lr: float, soft_weight: float,
                n_bounces: int, views_per_block: int = 4, round_state=None) -> dict:
    """{"losses": [step's loss], "grad": [leaf's gradient at step 1],
    "start": [leaf], "after": [leaf after ``steps`` steps]}, leaves in the
    order (atlas texels, emittance)."""
    dev = scene.device
    tgt = targets(scene, cams, width, height, seed, n_bounces, views_per_block, round_state)
    tex = scene.atlas.data if isinstance(scene.atlas, Atlas) else scene.atlas
    atlas = torch.full_like(tex, 0.5)
    atlas[..., 3] = tex[..., 3]
    leaves = [atlas, torch.zeros_like(scene.materials.emittance)]
    start = [x.clone() for x in leaves]
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    rays = [pixel_grid_rays(c, width, height) for c in cams]
    n_views, n_px = len(cams), rays[0][0].shape[0]
    losses, first_grad = [], None
    for step in range(steps):
        params = [x.detach().clone().requires_grad_(True) for x in leaves]
        sp = with_params(scene, {"atlas": params[0], "emittance": params[1]})
        total = 0.0
        for v0 in range(0, n_views, views_per_block):
            vs = range(v0, min(n_views, v0 + views_per_block))
            o = torch.cat([rays[i][0] for i in vs])
            d = torch.cat([rays[i][1] for i in vs])
            u = _uniforms(seed, (step + 1) << 32, v0 * n_px, len(vs) * n_px, n_bounces, dev)
            t = torch.cat([tgt[i] for i in vs])
            rad = trace_paths(sp, o, d, u, round_state).reshape(len(vs), n_px, 3)
            loss = torch.mean((rad - t.reshape(len(vs), n_px, 3)) ** 2, dim=(1, 2))
            if soft_weight > 0.0:
                soft = soft_radiance(sp, o, d, u=u[:, 0, :]).reshape(len(vs), n_px, 3)
                loss = loss + soft_weight * torch.mean((soft - t.reshape(len(vs), n_px, 3)) ** 2, dim=(1, 2))
            block = loss.sum() / n_views
            block.backward()
            total += float(block.detach())
        losses.append(total)
        grads = [p.grad for p in params]
        if first_grad is None:
            first_grad = [g.clone() for g in grads]
        k = step + 1
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = BETAS[0] * m[i] + (1.0 - BETAS[0]) * g
                v[i] = BETAS[1] * v[i] + (1.0 - BETAS[1]) * g * g
                m_hat = m[i] / (1.0 - BETAS[0] ** k)
                v_hat = v[i] / (1.0 - BETAS[1] ** k)
                leaves[i] = leaves[i] - lr * m_hat / (torch.sqrt(v_hat) + EPS)
            leaves[0] = leaves[0].clamp(0.0, 1.0)
            leaves[1] = leaves[1].clamp(min=0.0)
    return {"losses": losses, "grad": first_grad, "start": start, "after": leaves}
