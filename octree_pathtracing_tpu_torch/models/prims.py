"""Analytic (non-voxel) scene primitives: free spheres and free quads (port
of ``models/prims.py``).

A scene may hold a handful of them beside the octree; every ray is tested
against all of them and the nearer of the octree hit and the primitive hit
wins (``ops/shade.shade``).  :func:`intersect_prims` launches kernel K7
(``csrc/prims.cu``) for CUDA tensors and runs its plain-torch twin
:func:`intersect_prims_reference` for CPU tensors; there is no fallback from
one to the other.  On the card the main paths scan the primitives inside
K4's forward and ``nee_setup`` (``csrc/prims.cuh``, folded into
``csrc/shade.cu`` and ``csrc/nee.cu``), which read the tables
:func:`prim_tables` packs; :func:`intersect_prims` stays the entry point of
a single walk.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..ops.geometry import QuadSoA, QuadTable, make_quads, quad_hit, sphere_hit
from ..utils.cuda_build import on_current_stream


@dataclasses.dataclass
class Primitives:
    """Spheres as (S,) tables; ``quads`` a world-space :class:`QuadSoA` or
    None."""

    sphere_center: torch.Tensor  # (S, 3) float32
    sphere_radius: torch.Tensor  # (S,) float32
    sphere_mat: torch.Tensor  # (S,) int32
    quads: Any = None  # QuadSoA | None

    @property
    def n_spheres(self) -> int:
        return int(self.sphere_center.shape[0])

    def to(self, device) -> "Primitives":
        return Primitives(
            sphere_center=self.sphere_center.to(device),
            sphere_radius=self.sphere_radius.to(device),
            sphere_mat=self.sphere_mat.to(device),
            quads=None if self.quads is None else self.quads.to(device),
        )


def make_primitives(spheres=(), quads=None) -> Primitives:
    """``spheres``: iterable of (center (3,), radius, material id).
    ``quads``: None, the (origins, us, vs, material_ids) arrays of
    :func:`make_quads`, or a built :class:`QuadSoA`."""
    if spheres:
        centers = np.stack([np.asarray(c, np.float32) for c, _, _ in spheres])
        radii = np.array([r for _, r, _ in spheres], np.float32)
        mats = np.array([m for _, _, m in spheres], np.int32)
    else:
        centers = np.zeros((0, 3), np.float32)
        radii = np.zeros((0,), np.float32)
        mats = np.zeros((0,), np.int32)
    if quads is not None and not isinstance(quads, QuadSoA):
        quads = make_quads(*quads)
    return Primitives(
        sphere_center=torch.from_numpy(centers),
        sphere_radius=torch.from_numpy(radii),
        sphere_mat=torch.from_numpy(mats),
        quads=quads,
    )


def intersect_prims_reference(prims: Primitives, origins, dirs, t_max):
    """Plain-torch twin of kernel K7 (any device): the nearest primitive hit
    per lane, spheres first, then quads, in table order.

    Returns (hit (B,), t (B,) inf on a miss, mat (B,) int32, uv (B, 2),
    normal (B, 3))."""
    b = origins.shape[0]
    dev = origins.device
    best_t = torch.full((b,), float("inf"), dtype=torch.float32, device=dev)
    best_mat = torch.zeros((b,), dtype=torch.int32, device=dev)
    best_uv = torch.zeros((b, 2), dtype=torch.float32, device=dev)
    best_n = torch.zeros((b, 3), dtype=torch.float32, device=dev)

    for s in range(prims.n_spheres):
        hit, t, uv, n = sphere_hit(prims.sphere_center[s], prims.sphere_radius[s], origins, dirs)
        take = hit & (t < best_t) & (t < t_max)
        best_t = torch.where(take, t, best_t)
        best_mat = torch.where(take, prims.sphere_mat[s], best_mat)
        best_uv = torch.where(take[:, None], uv, best_uv)
        best_n = torch.where(take[:, None], n, best_n)

    if prims.quads is not None:
        zero_vox = torch.zeros_like(origins)
        for q in range(prims.quads.count):
            q_idx = torch.full((b,), q, dtype=torch.int64, device=dev)
            ok, t, uu, vv = quad_hit(prims.quads, q_idx, origins, dirs, zero_vox,
                                     torch.clamp(best_t, max=t_max))
            take = ok & (t < best_t) & (t < t_max)
            best_t = torch.where(take, t, best_t)
            best_mat = torch.where(take, prims.quads.material_id[q], best_mat)
            best_uv = torch.where(take[:, None], torch.stack([uu, vv], -1), best_uv)
            best_n = torch.where(take[:, None], prims.quads.normal[q], best_n)

    return torch.isfinite(best_t), best_t, best_mat, best_uv, best_n


class _SphereTable(ctypes.Structure):
    _fields_ = [("center", ctypes.c_void_p), ("radius", ctypes.c_void_p),
                ("material", ctypes.c_void_p), ("count", ctypes.c_int)]


class _PrimTables(ctypes.Structure):
    """``struct PrimTables`` of ``csrc/prims.cuh``."""

    _fields_ = [("spheres", _SphereTable), ("quads", QuadTable)]


def prim_tensors(prims: Primitives | None) -> tuple:
    """Every table tensor of ``prims`` that the scan reads, in a fixed order
    (spheres, then the quads' fields; None where there are none): what a
    scene's cached tables are keyed by."""
    if prims is None:
        return (None,) * (3 + len(QuadSoA._fields))
    quads = tuple(prims.quads) if prims.quads is not None else (None,) * len(QuadSoA._fields)
    return (prims.sphere_center, prims.sphere_radius, prims.sphere_mat) + quads


def check_tables(prims: Primitives, dev, who: str):
    """Raise (naming ``who``) where a table of ``prims`` is not what the scan
    reads: float32 / int32, contiguous, on card ``dev``."""
    tabs = [x for x in prim_tensors(prims) if x is not None]
    if not all(x.is_contiguous() and x.device == dev for x in tabs):
        raise ValueError(f"{who}: the primitive tables must be contiguous and on the lanes' card")
    if (prims.sphere_center.dtype != torch.float32 or prims.sphere_radius.dtype != torch.float32
            or prims.sphere_mat.dtype != torch.int32):
        raise ValueError(f"{who}: sphere tables must be float32 / int32")
    if prims.quads is not None and prims.quads.material_id.dtype != torch.int32:
        raise ValueError(f"{who}: quad materials must be int32")


def prim_tables(prims: Primitives | None) -> _PrimTables:
    """``prims``' tables as ``struct PrimTables`` (counts 0 where None)."""
    if prims is None:
        return _PrimTables(_SphereTable(None, None, None, 0), QuadTable.of(None))
    return _PrimTables(_SphereTable(prims.sphere_center.data_ptr(), prims.sphere_radius.data_ptr(),
                                    prims.sphere_mat.data_ptr(), prims.n_spheres), QuadTable.of(prims.quads))


def prim_count(prims: Primitives | None) -> int:
    """The spheres and quads of ``prims`` (0 where None)."""
    if prims is None:
        return 0
    return prims.n_spheres + (0 if prims.quads is None else prims.quads.count)


@functools.cache
def _library():
    """K7's shared library, built at first use."""
    from ..utils.cuda_build import load_library

    # no FMA contraction: the twin rounds every multiply and add on its own
    lib = load_library("prims", ("-fmad=false",))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.prims_intersect.argtypes = [vp, vp, ci, ctypes.c_float, ctypes.POINTER(_PrimTables),
                                    vp, vp, vp, vp, vp, vp]
    lib.prims_intersect.restype = ci
    lib.prims_error_string.argtypes = [ci]
    lib.prims_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(prims: Primitives, origins, dirs):
    b = origins.shape[0]
    checks = [
        (origins.dtype == torch.float32 and origins.shape == (b, 3), "origins must be (B, 3) float32"),
        (dirs.dtype == torch.float32 and dirs.shape == (b, 3), "dirs must be (B, 3) float32"),
        (origins.is_contiguous() and dirs.is_contiguous() and dirs.device == origins.device,
         "rays must be contiguous and on one device"),
        (b < 2**31, "too many rays for one launch"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"intersect_prims: {msg}")
    check_tables(prims, origins.device, "intersect_prims")


def _intersect_cuda(prims: Primitives, origins, dirs, t_max):
    _check_cuda(prims, origins, dirs)
    b = origins.shape[0]
    hit = origins.new_empty((b,), dtype=torch.bool)
    t = origins.new_empty((b,))
    mat = origins.new_empty((b,), dtype=torch.int32)
    uv = origins.new_empty((b, 2))
    normal = origins.new_empty((b, 3))
    if b == 0:  # an empty batch launches nothing
        return hit, t, mat, uv, normal
    tables = prim_tables(prims)
    lib = _library()
    rc = on_current_stream(lib.prims_intersect, origins.get_device(), origins.data_ptr(), dirs.data_ptr(),
                           b, float(t_max), ctypes.byref(tables), hit.data_ptr(), t.data_ptr(),
                           mat.data_ptr(), uv.data_ptr(), normal.data_ptr())
    if rc != 0:
        raise RuntimeError(f"prims_intersect launch failed: {lib.prims_error_string(rc).decode()}")
    intersect_prims.launches += 1
    return hit, t, mat, uv, normal


def intersect_prims(prims: Primitives, origins, dirs, t_max):
    """Nearest analytic-primitive hit per lane: spheres take their nearest
    root beyond EPSILON with lat/long uv; quads are backface-culled; a
    candidate counts where ``t < best_t`` and ``t < t_max``.

    Returns (hit (B,), t (B,) inf on a miss, mat (B,) int32, uv (B, 2),
    normal (B, 3)).  CUDA tensors launch kernel K7 and count the launch in
    ``intersect_prims.launches``; CPU tensors run
    :func:`intersect_prims_reference`.  Any other device raises."""
    if origins.is_cuda:
        return _intersect_cuda(prims, origins, dirs, t_max)
    if origins.device.type == "cpu":
        return intersect_prims_reference(prims, origins, dirs, t_max)
    raise ValueError(f"intersect_prims: unsupported device {origins.device}")


intersect_prims.launches = 0
