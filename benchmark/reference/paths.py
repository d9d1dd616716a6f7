"""What a cell's timed path must produce, at chosen pixels or steps.

- :func:`view_pixels`: the framebuffer of a progressive view at chosen
  pixels after its passes, from the seed: the pass schedule, each pass's
  jitter and uniform streams (Philox by counter), every sample's path, and
  the running average, each in the order the renderer folds them.

Every lane is traced in blocks of ``block`` rows, so the reference fits
beside nothing else on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .plain.models.camera import get_rays, normalize_pixel_coords
from .plain.ops.random import bits_to_unit, philox4x32_10
from .plain.ops.shading import N_UNIFORMS
from .plain.render.pathtracer import trace_paths

_MASK = 0xFFFFFFFF


def philox_at(seed: int, counter: int, index, device):
    """Elements ``index`` (int64 tensor) of the uniform stream ``counter``
    under ``seed``: element ``i`` is word ``i % 4`` of Philox4x32-10 block
    ``i // 4``, keyed by the seed, with counter (block, stream)."""
    index = index.to(device=device, dtype=torch.int64)
    block = index // 4
    words = philox4x32_10(
        (block & _MASK, (block >> 32) & _MASK,
         torch.full_like(block, counter & _MASK), torch.full_like(block, counter >> 32)),
        (seed & _MASK, seed >> 32),
    )
    return bits_to_unit(torch.stack(words, dim=1).gather(1, (index % 4)[:, None])[:, 0])


def branch_schedule(current_spp: int, branch_count: int) -> int:
    """Samples of the next pass: single samples first, then a ramp so the
    count lands on a multiple of ``branch_count``."""
    if current_spp < branch_count:
        if current_spp <= int(np.sqrt(branch_count)):
            return 1
        return branch_count - current_spp
    return branch_count


def pass_plan(target_spp: int, branch_count: int) -> list:
    """[(samples, counter)] of every pass of a view from a reset."""
    plan, spp, counter = [], 0, 0
    while spp < target_spp:
        n = min(branch_schedule(spp, branch_count), target_spp - spp)
        plan.append((n, counter))
        spp += n
        counter += 2 * n
    return plan


def _pixel_rays(cam, width: int, height: int, pixels, jitter):
    px = (pixels % width).to(torch.float32)
    py = (pixels // width).to(torch.float32)
    xn, yn = normalize_pixel_coords(px, py, width, height)
    if jitter is not None:
        xn = xn + jitter[:, 0]
        yn = yn + jitter[:, 1]
    return get_rays(cam, xn, yn)


def _pass_lanes(cam, width, height, pixels, seed, n, counter, n_bounces, device):
    """Rays and uniform rows of one pass's ``len(pixels) * n`` lanes,
    pixel-major (lane ``p * n + k`` is sample ``k`` of pixel ``p``)."""
    p = pixels.to(device=device, dtype=torch.int64)
    dim = float(max(width, height))
    j = philox_at(seed, counter, torch.stack([2 * p, 2 * p + 1], 1).reshape(-1), device).reshape(-1, 2)
    o, d = _pixel_rays(cam, width, height, p, j * (2.0 / dim) - 1.0 / dim)
    lane = (p[:, None] * n + torch.arange(n, device=device)[None, :]).reshape(-1)
    words = (lane[:, None] * (n_bounces * N_UNIFORMS) + torch.arange(n_bounces * N_UNIFORMS, device=device)[None, :])
    u = philox_at(seed, counter + 1, words.reshape(-1), device).reshape(-1, n_bounces, N_UNIFORMS)
    return o.repeat_interleave(n, 0), d.repeat_interleave(n, 0), u


def traced(scene, origins, dirs, u, block: int, round_state=None):
    """``trace_paths`` over the lanes in blocks of ``block`` rows."""
    outs = []
    with torch.no_grad():
        for s in range(0, origins.shape[0], block):
            outs.append(trace_paths(scene, origins[s:s + block], dirs[s:s + block], u[s:s + block], round_state))
    return torch.cat(outs)


def view_pixels(scene, cam, width: int, height: int, pixels, seed: int, target_spp: int, branch_count: int,
                n_bounces: int, block: int = 1 << 16, round_state=None, round_frame=None):
    """(P, 3) framebuffer values at ``pixels`` (flat row-major indices)
    after a view's passes to ``target_spp`` from a reset under ``seed``.
    ``round_state`` / ``round_frame``: the precision control's rounding of
    the lane state after each bounce and of the framebuffer after each
    pass."""
    dev = scene.device
    plan = pass_plan(target_spp, branch_count)
    lanes = [_pass_lanes(cam, width, height, pixels, seed, n, c, n_bounces, dev) for n, c in plan]
    rad = traced(scene, torch.cat([x[0] for x in lanes]), torch.cat([x[1] for x in lanes]),
                 torch.cat([x[2] for x in lanes]), block, round_state)
    fb = torch.zeros((pixels.shape[0], 3), dtype=torch.float32, device=dev)
    spp, at = 0, 0
    for n, _ in plan:
        r = rad[at:at + pixels.shape[0] * n].reshape(-1, n, 3)
        at += r.shape[0] * n
        new = r[:, 0] if n == 1 else r.mean(dim=1) * n
        fb = (fb * float(spp) + new) / float(spp + n)
        if round_frame is not None:
            fb = round_frame(fb)
        spp += n
    return fb

