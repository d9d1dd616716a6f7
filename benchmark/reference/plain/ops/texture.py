"""Texture atlas sampling + gamma transforms (port of ``ops/texture.py``).

Nearest-neighbour fetch with the reference's clamp and v-flip.  Textures
live in one stacked ``(T, H, W, 4)`` float32 linear atlas, or in a
variable-resolution :class:`Atlas` whose layers keep their native sizes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

GAMMA = 2.2


def srgb_to_linear(c):
    """Byte-channel [0,1] sRGB -> linear (power-law LUT semantics)."""
    return torch.clamp(c, 0.0, 1.0).pow(GAMMA)


def linear_to_srgb(c):
    """Linear -> display: the simple power gamma 1/2.2, not the piecewise
    sRGB curve."""
    return torch.clamp(c, 0.0, 1.0).pow(1.0 / GAMMA)


@dataclasses.dataclass
class Atlas:
    """Variable-resolution atlas: layers edge-padded into one
    ``(T, Hmax, Wmax, 4)`` linear float32 tensor plus a ``(T, 2)`` int32
    per-layer ``(h, w)`` size table consulted at sample time."""

    data: torch.Tensor
    sizes: torch.Tensor

    @property
    def shape(self):
        return self.data.shape

    def to(self, device) -> "Atlas":
        return Atlas(self.data.to(device), self.sizes.to(device))


def _to_rgba8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3 + [np.full_like(img, 255)], -1)
    if img.shape[2] == 3:
        img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, img.dtype)], -1)
    return img


def _to_linear(img: np.ndarray) -> np.ndarray:
    """RGBA8 -> linear float32; RGB converts sRGB->linear, alpha stays linear."""
    f = img.astype(np.float32) / 255.0
    f[:, :, :3] **= GAMMA
    return f


def build_atlas(images: list[np.ndarray], size: int | None = 16):
    """Stack RGBA8 images into a linear float32 atlas.

    ``size`` given (default 16): nearest-resample every image to
    (size, size) and return a ``(T, size, size, 4)`` tensor.  ``size=None``:
    keep native resolutions and return an :class:`Atlas`.
    """
    if size is None:
        imgs = [_to_rgba8(im) for im in images]
        hmax = max(im.shape[0] for im in imgs)
        wmax = max(im.shape[1] for im in imgs)
        atlas = np.zeros((len(imgs), hmax, wmax, 4), np.float32)
        sizes = np.zeros((len(imgs), 2), np.int32)
        for t, img in enumerate(imgs):
            h, w = img.shape[:2]
            # clamp-replicate into the padded frame: never sampled, but keeps
            # full-layer reductions (min alpha) equal to the valid region's
            yi = np.arange(hmax).clip(0, h - 1)
            xi = np.arange(wmax).clip(0, w - 1)
            atlas[t] = _to_linear(img)[yi][:, xi]
            sizes[t] = (h, w)
        return Atlas(torch.from_numpy(atlas), torch.from_numpy(sizes))
    atlas = np.zeros((len(images), size, size, 4), np.float32)
    for t, img in enumerate(images):
        img = _to_rgba8(img)
        h, w = img.shape[:2]
        yi = (np.arange(size) * h // size).clip(0, h - 1)
        xi = (np.arange(size) * w // size).clip(0, w - 1)
        atlas[t] = _to_linear(img[yi][:, xi])
    return torch.from_numpy(atlas)


def _texel_ij(atlas, layer, u, v):
    """(texels, layer, j, i): the atlas's (T, H, W, 4) texels and the row
    and column of each lane's nearest texel, with the reference's clamp and
    v-flip."""
    layer = layer.long()
    if isinstance(atlas, Atlas):
        data = atlas.data
        hw = atlas.sizes[layer]
        t_h, t_w = hw[..., 0], hw[..., 1]
    else:
        data = atlas
        t_h, t_w = data.shape[1], data.shape[2]
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    i = torch.clamp((uu * t_w).to(torch.int32), min=0)
    j = torch.clamp((vv * t_h).to(torch.int32), min=0)
    i = torch.where(i > t_w - 1, t_w - 1, i)
    j = torch.where(j > t_h - 1, t_h - 1, j)
    return data, layer, j.long(), i.long()


def sample_atlas(atlas, layer, u, v):
    """Nearest-neighbour fetch with clamp + v-flip; returns (B, 4) linear
    RGBA.  ``atlas`` is a uniform ``(T, H, W, 4)`` tensor or an
    :class:`Atlas`.  Differentiable in the texels; ``u, v`` get no gradient."""
    data, layer, j, i = _texel_ij(atlas, layer, u, v)
    return data[layer, j, i]


def texel_index(atlas, layer, u, v):
    """(B,) int64: the texel :func:`sample_atlas` reads, as a row of the
    atlas's texels viewed as ``(T * H * W, 4)``."""
    data, layer, j, i = _texel_ij(atlas, layer, u, v)
    return (layer * data.shape[1] + j) * data.shape[2] + i
