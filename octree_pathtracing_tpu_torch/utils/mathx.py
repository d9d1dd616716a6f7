"""Scalar and vector math helpers (port of ``utils/mathx.py``): step and
smoothstep, angle distance, degrees to radians, near-zero test, unit-disk
and defocus-disk samples from explicit uniforms instead of a stateful RNG."""

from __future__ import annotations

import numpy as np
import torch

PI = np.pi


def degrees_to_rads(d):
    return d * PI / 180.0


def step(edge, x):
    return torch.where(x <= edge, 0.0, 1.0)


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def angle_distance(a1, a2):
    diff = torch.abs(a1 - a2) % (2.0 * PI)
    return torch.where(diff > PI, 2.0 * PI - diff, diff)


def near_zero(v, s=1e-8):
    return torch.all(torch.abs(v) < s, dim=-1)


def sample_unit_disk(u1, u2):
    """Uniform disk point by the polar warp; (B,) uniforms -> (B, 2)."""
    r = torch.sqrt(u1)
    theta = 2.0 * PI * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def defocus_disk_sample(center, disc_u, disc_v, u1, u2):
    """Thin-lens aperture sample: ``center`` plus a unit-disk point in the
    (disc_u, disc_v) frame; (B,) uniforms -> (B, 3)."""
    p = sample_unit_disk(u1, u2)
    return center + p[:, 0:1] * disc_u[None, :] + p[:, 1:2] * disc_v[None, :]
