"""Kernel K10, the flat-shaded preview's resolve and shade (port of
``render/preview.py`` :33-39 with ``models/sun.flat_shading``).

Per pixel of a walked batch: on a hit, the hit's material, uv and normal
(``ops/shade.resolve_hit``: the leaf's material, a block model's face
material, or a quad model's quad that K2q's mode 1 found), the material's
texel forced opaque, shaded by ``max(AMBIENT, n . sw)`` times the sun's
emittance; on a miss the sky with the sun's window.  :func:`preview_shade`
launches ``csrc/preview.cu`` on CUDA tensors and runs the plain-torch twin
:func:`preview_shade_reference` on CPU tensors; there is no fallback from
one to the other.  Like the JAX preview it ignores analytic primitives.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.scene import Scene
from ..models.sun import add_sun_color, flat_shading, sky_color
from ..utils.cuda_build import on_current_stream
from .shade import resolve_hit
from .texture import Atlas, sample_atlas
from .traversal import HitResult


def preview_shade_reference(scene: Scene, dirs, res: HitResult):
    """The plain-torch twin: (B, 3) linear RGB of the walked rays."""
    mat, uv, normals, _ = resolve_hit(scene, dirs, dirs, res)
    layer = scene.materials.texture_index[mat.long()]
    albedo = sample_atlas(scene.atlas, layer, uv[:, 0], uv[:, 1])
    shaded = flat_shading(scene.sun, normals, albedo[:, :3])
    sky = add_sun_color(scene.sun, dirs, sky_color((dirs.shape[0],), dirs.device))
    return torch.where(res.hit[:, None], shaded, sky[:, :3])


def preview_shade(scene: Scene, dirs, res: HitResult):
    """(B, 3) float32 linear RGB of rays ``dirs`` whose walk gave ``res``
    (on a scene with quad models, ``res.quad`` from the accepting walk).
    CUDA tensors launch K10 and count it in ``preview_shade.launches``; CPU
    tensors run :func:`preview_shade_reference`.  Any other device raises."""
    if dirs.is_cuda:
        return _shade_cuda(scene, dirs, res)
    if dirs.device.type == "cpu":
        return preview_shade_reference(scene, dirs, res)
    raise ValueError(f"preview_shade: unsupported device {dirs.device}")


preview_shade.launches = 0


# ---- the CUDA kernel

class _Tables(ctypes.Structure):
    """``struct PreviewTables`` of ``csrc/preview.cu``."""

    _fields_ = [("leaf_material", ctypes.c_void_p), ("n_leaf", ctypes.c_int),
                ("leaf_model", ctypes.c_void_p), ("n_leaf_model", ctypes.c_int),
                ("face_material", ctypes.c_void_p), ("texture_index", ctypes.c_void_p),
                ("atlas", ctypes.c_void_p), ("sizes", ctypes.c_void_p),
                ("atlas_h", ctypes.c_int), ("atlas_w", ctypes.c_int),
                ("sw", ctypes.c_void_p), ("su", ctypes.c_void_p), ("sv", ctypes.c_void_p),
                ("radius", ctypes.c_void_p), ("emittance", ctypes.c_void_p), ("apparent", ctypes.c_void_p),
                ("draw_texture", ctypes.c_int)]


class _Lanes(ctypes.Structure):
    """``struct PreviewLanes`` of ``csrc/preview.cu``."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("hit", "face_id", "uv", "leaf_value", "q_found", "q_mat",
                                               "q_uv", "q_normal", "dirs", "out")] + [("n", ctypes.c_int)]


@functools.cache
def _library():
    """K10's shared library, built at first use."""
    from ..utils.cuda_build import load_library

    # no FMA contraction: the twin's eager torch rounds every multiply and add
    lib = load_library("preview", ("-fmad=false",))
    vp = ctypes.c_void_p
    lib.preview_shade.argtypes = [ctypes.POINTER(_Tables), ctypes.POINTER(_Lanes), vp]
    lib.preview_shade.restype = ctypes.c_int
    lib.preview_error_string.argtypes = [ctypes.c_int]
    lib.preview_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def _checked(x, shape, dtype, name: str, dev):
    """``x`` dense, or a refusal naming it."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != dev:
        raise ValueError(f"preview_shade: {name} must be a {tuple(shape)} {dtype} on {dev}")
    return x.contiguous()


def _tables(scene: Scene, dev) -> tuple:
    """(struct, the tensors it points into) of ``scene``'s tables."""
    atlas = scene.atlas
    data = atlas.data if isinstance(atlas, Atlas) else atlas
    sizes = atlas.sizes if isinstance(atlas, Atlas) else None
    f32, i32 = torch.float32, torch.int32
    if data.dim() != 4 or data.shape[3] != 4:
        raise ValueError("preview_shade: the atlas must be (T, H, W, 4)")
    data = _checked(data, data.shape, f32, "the atlas", dev)
    if sizes is not None:
        sizes = _checked(sizes, (data.shape[0], 2), i32, "the atlas sizes", dev)
    leaf_material = _checked(scene.leaf_material, scene.leaf_material.shape, i32, "leaf_material", dev)
    tex = scene.materials.texture_index
    tex = _checked(tex, tex.shape, i32, "materials.texture_index", dev)
    m = scene.models
    leaf_model = face_material = None
    if m is not None:
        leaf_model = _checked(m.leaf_model, m.leaf_model.shape, i32, "models.leaf_model", dev)
        face_material = _checked(m.face_material, (m.face_material.shape[0], 6), i32, "models.face_material", dev)
    sun = scene.sun
    sun_t = [_checked(getattr(sun, f), shape, f32, f"sun.{f}", dev)
             for f, shape in (("sw", (3,)), ("su", (3,)), ("sv", (3,)), ("radius", ()), ("emittance", (4,)),
                              ("apparent_texture_brightness", (3,)))]
    keep = (data, sizes, leaf_material, tex, leaf_model, face_material, *sun_t)
    tables = _Tables(leaf_material.data_ptr(), leaf_material.shape[0], _ptr(leaf_model),
                     0 if leaf_model is None else leaf_model.shape[0], _ptr(face_material), tex.data_ptr(),
                     data.data_ptr(), _ptr(sizes), data.shape[1], data.shape[2],
                     *(x.data_ptr() for x in sun_t), int(sun.draw_texture))
    return tables, keep


def _shade_cuda(scene: Scene, dirs, res: HitResult):
    dev = dirs.device
    b = dirs.shape[0]
    if b >= 2**31:
        raise ValueError("preview_shade: too many rays for one launch")
    f32, i32 = torch.float32, torch.int32
    dirs = _checked(dirs, (b, 3), f32, "dirs", dev)
    lanes = [_checked(res.hit, (b,), torch.bool, "res.hit", dev), _checked(res.face_id, (b,), i32, "res.face_id", dev),
             _checked(res.uv, (b, 2), f32, "res.uv", dev), _checked(res.leaf_value, (b,), i32, "res.leaf_value", dev)]
    q = res.quad
    if scene.models is not None and scene.has_quad_models:
        if q is None:
            raise ValueError("preview_shade: a scene with quad models needs the accepting walk's quad surfaces")
        lanes += [_checked(q.found, (b,), torch.bool, "res.quad.found", dev),
                  _checked(q.mat, (b,), i32, "res.quad.mat", dev), _checked(q.uv, (b, 2), f32, "res.quad.uv", dev),
                  _checked(q.normal, (b, 3), f32, "res.quad.normal", dev)]
    else:
        lanes += [None] * 4
    out = torch.empty((b, 3), dtype=f32, device=dev)
    if b == 0:  # an empty batch launches nothing
        return out
    tables, _tensors = _tables(scene, dev)  # _tensors: what the struct points into
    args = _Lanes(*(_ptr(x) for x in lanes), dirs.data_ptr(), out.data_ptr(), b)
    lib = _library()
    rc = on_current_stream(lib.preview_shade, dirs.get_device(), ctypes.byref(tables), ctypes.byref(args))
    if rc != 0:
        raise RuntimeError(f"preview_shade launch failed: {lib.preview_error_string(rc).decode()}")
    preview_shade.launches += 1
    return out
