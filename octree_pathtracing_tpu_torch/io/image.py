"""Image I/O (port of ``io/image.py``): linear float frames to
gamma-compressed files, and resource-pack textures in.  PNG goes through
PIL where it is installed; a ``.ppm`` path, or any path where PIL is
missing, is written as binary PPM.  Loading an image needs PIL."""

from __future__ import annotations

import numpy as np

from ..ops.texture import float_to_u8


def _write_ppm(path: str, u8: np.ndarray) -> None:
    h, w = u8.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(u8).tobytes())


def save_image(path: str, img) -> str:
    """Save a linear-float (H, W, 3|4) image (array or tensor); returns the
    path written (``.ppm`` appended when PIL is missing)."""
    u8 = float_to_u8(img)[..., :3]
    if path.endswith(".ppm"):
        _write_ppm(path, u8)
        return path
    try:
        from PIL import Image
    except ImportError:
        path = path + ".ppm"
        _write_ppm(path, u8)
        return path
    Image.fromarray(u8, "RGB").save(path)
    return path


def load_image(path: str) -> np.ndarray:
    """Load an image file as (H, W, 4) RGBA8 (PIL required)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGBA"))
