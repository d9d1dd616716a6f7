"""Color conversions (copy of ``utils/colors.py``, numpy as there): linear
float RGBA to and from gamma-compressed bytes through the reference's
256-entry gamma tables."""

from __future__ import annotations

import numpy as np

GAMMA = 2.2

# the reference's tables, for byte-exact conversions
LUT_FLOAT = (np.arange(256) / 255.0) ** GAMMA
LUT_BYTE = ((np.arange(256) / 255.0) ** (1.0 / GAMMA) * 255.0).astype(np.uint8)


def u8_to_f32(rgba_u8: np.ndarray) -> np.ndarray:
    """RGBA8 -> float: gamma-table RGB, linear alpha."""
    rgba_u8 = np.asarray(rgba_u8, np.uint8)
    out = np.empty(rgba_u8.shape, np.float32)
    out[..., :3] = LUT_FLOAT[rgba_u8[..., :3]]
    out[..., 3] = rgba_u8[..., 3] / 255.0
    return out


def f32_to_u8(rgba_f32: np.ndarray) -> np.ndarray:
    """Float RGB(A) -> bytes through the byte gamma table."""
    c = np.clip(np.asarray(rgba_f32), 0.0, 1.0)
    idx = (c[..., :3] * 255.0).astype(np.uint8)
    out = np.empty(c.shape, np.uint8)
    out[..., :3] = LUT_BYTE[idx]
    if c.shape[-1] == 4:
        out[..., 3] = (c[..., 3] * 255.0).astype(np.uint8)
    return out
