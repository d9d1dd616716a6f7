"""Thin-lens perspective camera — vectorized ray generation (port of
``models/camera.py``).  ``d = cot(fov/2)``, ``right = direction x up``,
pixel coordinates normalized to the [-1, 1] box of the longer image axis
with the reference's pixel-centre convention; depth of field from an
aperture disk aimed at the focal plane (:func:`get_rays_dof`), and the
camera controls :func:`move_camera` and :func:`rotate_camera`."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _cross(a, b):
    """Cross product over the last axis (component formula of ``jnp.cross``)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _normalize(x):
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


@dataclasses.dataclass
class Camera:
    eye: torch.Tensor  # (3,)
    direction: torch.Tensor  # (3,) unit
    up: torch.Tensor  # (3,) unit, orthogonal to direction
    fov: float = float(np.radians(70.0))
    aperture: float = 0.0  # the lens radius; 0 is a pinhole
    focal_distance: float = 0.0

    @staticmethod
    def look_at(eye, center, up=(0.0, 1.0, 0.0), fov_radians=float(np.radians(70.0))):
        """Perspective camera looking at a point."""
        eye = torch.as_tensor(eye, dtype=torch.float32)
        center = torch.as_tensor(center, dtype=torch.float32)
        up = torch.as_tensor(up, dtype=torch.float32)
        direction = _normalize(center - eye)
        up = _normalize(up - torch.dot(up, direction) * direction)
        return Camera(eye=eye, direction=direction, up=up, fov=fov_radians)

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, eye=self.eye.to(device), direction=self.direction.to(device), up=self.up.to(device)
        )


def normalize_pixel_coords(px, py, width: int, height: int):
    """Pixel index -> [-1, 1] box coords."""
    dim = float(max(width, height))
    xn = ((2.0 * px + 1.0) - width) / dim
    yn = ((2.0 * (height - py) - 1.0) - height) / dim
    return xn, yn


def get_rays(camera: Camera, xn, yn):
    """Batched ``Camera::get_ray``: (B,) normalized screen coords ->
    origins (B, 3), unit directions (B, 3)."""
    half_fov = torch.tensor(camera.fov * 0.5, dtype=torch.float32, device=xn.device)
    d = 1.0 / torch.tan(half_fov)
    direction = camera.direction
    up = camera.up
    right = _cross(direction, up)
    dirs = d * direction[None, :] + xn[:, None] * right[None, :] + yn[:, None] * up[None, :]
    dirs = _normalize(dirs)
    origins = camera.eye.expand(dirs.shape)
    return origins, dirs


def get_rays_dof(camera: Camera, xn, yn, u1, u2):
    """Thin-lens rays with depth of field: origins on the aperture disk,
    aimed at the point of the pinhole ray at ``focal_distance``.  ``u1, u2``:
    (B,) uniforms of the lens sample.  A camera without aperture gives
    :func:`get_rays`' rays."""
    origins, dirs = get_rays(camera, xn, yn)
    if float(camera.aperture) <= 0.0:
        return origins, dirs
    right = _cross(camera.direction, camera.up)
    focal_point = origins + dirs * camera.focal_distance
    r = torch.sqrt(u1) * camera.aperture
    theta = 2.0 * np.pi * u2
    offset = right[None, :] * (r * torch.cos(theta))[:, None] + camera.up[None, :] * (r * torch.sin(theta))[:, None]
    new_origins = origins + offset
    return new_origins, _normalize(focal_point - new_origins)


def move_camera(camera: Camera, forward=0.0, strafe=0.0, vertical=0.0) -> Camera:
    """Translate the eye along the view direction, the right vector and the
    world's up (the reference's WASD / space / shift moves)."""
    right = _normalize(_cross(camera.direction, camera.up))
    world_up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=camera.eye.device)
    eye = camera.eye + camera.direction * forward + right * strafe + world_up * vertical
    return dataclasses.replace(camera, eye=eye)


def rotate_camera(camera: Camera, yaw: float, pitch: float) -> Camera:
    """Point the camera by absolute yaw and pitch (radians), the pitch
    clamped to +-80 degrees, the up vector rebuilt upright."""
    pitch = float(np.clip(pitch, -np.radians(80.0), np.radians(80.0)))
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    dev = camera.eye.device
    direction = _normalize(torch.tensor([cp * sy, sp, cp * cy], dtype=torch.float32, device=dev))
    world_up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    right = _normalize(_cross(direction, world_up))
    up = _normalize(_cross(right, direction))
    return dataclasses.replace(camera, direction=direction, up=up)


def pixel_grid_rays(camera: Camera, width: int, height: int, jitter=None):
    """Rays for the full pixel grid, row-major (y outer, x inner).

    ``jitter``: optional (H*W, 2) offsets in [-1/dim, 1/dim]."""
    dev = camera.eye.device
    px, py = torch.meshgrid(
        torch.arange(width, dtype=torch.float32, device=dev),
        torch.arange(height, dtype=torch.float32, device=dev),
        indexing="xy",
    )
    xn, yn = normalize_pixel_coords(px.reshape(-1), py.reshape(-1), width, height)
    if jitter is not None:
        xn = xn + jitter[:, 0]
        yn = yn + jitter[:, 1]
    return get_rays(camera, xn, yn)
