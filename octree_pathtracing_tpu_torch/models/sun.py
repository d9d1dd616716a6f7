"""Sun + sky model (port of ``models/sun.py``): Chunky-style angular sun,
sky colour constant and the sampling-strategy flag sets.  The basis vectors
(su, sv, sw) are derived once at construction; every field is a float32
tensor so a whole :class:`Sun` moves with ``.to(device)``."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PI = np.pi

SKY_COLOR = (0.5, 0.7, 1.0, 1.0)

DEFAULT_AZIMUTH = PI / 2.5
DEFAULT_ALTITUDE = PI / 3.0
DEFAULT_RADIUS = 0.03
DEFAULT_IMPORTANCE_SAMPLE_CHANCE = 0.1
MAX_IMPORTANCE_SAMPLE_CHANCE = 0.9
DEFAULT_IMPORTANCE_SAMPLE_RADIUS = 1.2
AMBIENT = 0.3
INTENSITY = 1.25
GAMMA = 2.2
DEFAULT_LUMINOSITY = 100.0


@dataclasses.dataclass
class SunSampling:
    """Strategy knobs.  Defaults = IMPORTANCE."""

    sun_sampling: bool = False
    diffuse_sun: bool = True
    strict_direct_light: bool = False
    sun_luminosity: bool = True
    importance_sampling: bool = True

    @staticmethod
    def off():
        return SunSampling(False, True, False, True, False)

    @staticmethod
    def non_luminous():
        return SunSampling(False, False, False, False, False)

    @staticmethod
    def fast():
        return SunSampling(True, False, False, False, False)

    @staticmethod
    def importance():
        return SunSampling(False, True, False, True, True)

    @staticmethod
    def high_quality():
        return SunSampling(True, True, True, True, False)


_TENSOR_FIELDS = (
    "azimuth",
    "altitude",
    "radius",
    "color",
    "luminosity",
    "importance_sample_chance",
    "importance_sample_radius",
    "sw",
    "su",
    "sv",
    "radius_cos",
    "radius_sin",
    "emittance",
    "apparent_texture_brightness",
)


@dataclasses.dataclass
class Sun:
    azimuth: torch.Tensor  # () f32
    altitude: torch.Tensor
    radius: torch.Tensor
    color: torch.Tensor  # (4,)
    luminosity: torch.Tensor
    importance_sample_chance: torch.Tensor
    importance_sample_radius: torch.Tensor
    sw: torch.Tensor  # (3,) direction toward the sun
    su: torch.Tensor  # (3,)
    sv: torch.Tensor  # (3,)
    radius_cos: torch.Tensor
    radius_sin: torch.Tensor
    emittance: torch.Tensor  # (4,) color * INTENSITY^GAMMA
    apparent_texture_brightness: torch.Tensor  # (3,)
    draw_texture: bool = True

    def to(self, device) -> "Sun":
        moved = {f: getattr(self, f).to(device) for f in _TENSOR_FIELDS}
        return Sun(**moved, draw_texture=self.draw_texture)

    @property
    def luminosity_pdf(self):
        return 1.0 / self.luminosity


def _f32(x):
    return torch.tensor(np.float32(x))


def make_sun(
    azimuth=DEFAULT_AZIMUTH,
    altitude=DEFAULT_ALTITUDE,
    radius=DEFAULT_RADIUS,
    color=(1.0, 1.0, 1.0, 1.0),
    luminosity=DEFAULT_LUMINOSITY,
    draw_texture=True,
) -> Sun:
    """``Sun::new``: derive the (su, sv, sw) basis and the emittance."""
    theta, phi = float(azimuth), float(altitude)
    r = abs(np.cos(phi))
    sw = np.array([np.cos(theta) * r, np.sin(phi), np.sin(theta) * r], np.float32)
    su = (
        np.array([0.0, 1.0, 0.0], np.float32)
        if abs(sw[0]) > 0.1
        else np.array([1.0, 0.0, 0.0], np.float32)
    )
    sv = np.cross(sw, su)
    sv = sv / np.linalg.norm(sv)
    su = np.cross(sv, sw)
    color = np.asarray(color, np.float32)
    emittance = color * (INTENSITY**GAMMA)
    apparent = np.ones(3, np.float32) * (INTENSITY**GAMMA)
    return Sun(
        azimuth=_f32(azimuth),
        altitude=_f32(altitude),
        radius=_f32(radius),
        color=torch.from_numpy(color),
        luminosity=_f32(luminosity),
        importance_sample_chance=_f32(DEFAULT_IMPORTANCE_SAMPLE_CHANCE),
        importance_sample_radius=_f32(DEFAULT_IMPORTANCE_SAMPLE_RADIUS),
        sw=torch.from_numpy(sw),
        su=torch.from_numpy(su.astype(np.float32)),
        sv=torch.from_numpy(sv.astype(np.float32)),
        radius_cos=_f32(np.cos(radius)),
        radius_sin=_f32(np.sin(radius)),
        emittance=torch.from_numpy(emittance.astype(np.float32)),
        apparent_texture_brightness=torch.from_numpy(apparent.astype(np.float32)),
        draw_texture=draw_texture,
    )


def sun_disk_factor(sun: Sun, directions):
    """Angular-window sun draw.  Returns (in_disk (B,), u (B,), v (B,)):
    whether each direction lands in the sun's texture window, and the
    window coordinates."""
    d = directions
    cos_sw = d @ sun.sw
    width = sun.radius * 4.0
    width2 = width * 2.0
    a = PI / 2.0 - torch.acos(torch.clamp(d @ sun.su, -1.0, 1.0)) + width
    b = PI / 2.0 - torch.acos(torch.clamp(d @ sun.sv, -1.0, 1.0)) + width
    in_disk = (cos_sw >= 0.5) & (a >= 0.0) & (a < width2) & (b >= 0.0) & (b < width2)
    return in_disk, a / width2, b / width2


def _with_rgb(color, rgb):
    return torch.cat([rgb, color[:, 3:]], dim=-1)


def add_sun_color(sun: Sun, directions, color):
    """Specular/sky-path sun draw: adds the apparent texture brightness x10
    inside the sun window.  ``color`` is (B, 4); returns (B, 4)."""
    if not sun.draw_texture:
        return color
    in_disk, _, _ = sun_disk_factor(sun, directions)
    sun_rgb = sun.apparent_texture_brightness * 10.0
    add = torch.where(in_disk[:, None], color[:, :3] + sun_rgb[None, :], color[:, :3])
    return _with_rgb(color, add)


def add_sun_color_diffuse(sun: Sun, directions, color):
    """Diffuse-path sun draw: luminosity-scaled.  (B, 4) -> (B, 4)."""
    in_disk, _, _ = sun_disk_factor(sun, directions)
    sun_rgb = sun.color[:3] * 10.0 * sun.luminosity
    add = torch.where(in_disk[:, None], color[:, :3] + sun_rgb[None, :], color[:, :3])
    return _with_rgb(color, add)


def sky_color(batch_shape, device=None):
    return torch.tensor(SKY_COLOR, dtype=torch.float32, device=device).expand(
        tuple(batch_shape) + (4,)
    )


def random_sun_direction(sun: Sun, u1, u2):
    """Uniform cone sample toward the sun:
    dir = su*cos(phi)*sin_a + sv*sin(phi)*sin_a + sw*cos_a."""
    cos_a = 1.0 - u1 + u1 * sun.radius_cos
    sin_a = torch.sqrt(1.0 - cos_a * cos_a)
    phi = 2.0 * PI * u2
    return (
        sun.su[None, :] * (torch.cos(phi) * sin_a)[:, None]
        + sun.sv[None, :] * (torch.sin(phi) * sin_a)[:, None]
        + sun.sw[None, :] * cos_a[:, None]
    )
