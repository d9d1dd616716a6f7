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

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops.geometry import QuadSoA, make_quads, quad_hit, sphere_hit


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


def intersect_prims(prims: Primitives, origins, dirs, t_max):
    """Nearest analytic-primitive hit per lane: spheres take their nearest
    root beyond EPSILON with lat/long uv; quads are backface-culled; a
    candidate counts where ``t < best_t`` and ``t < t_max``.

    Returns (hit (B,), t (B,) inf on a miss, mat (B,) int32, uv (B, 2),
    normal (B, 3)).  CUDA tensors launch kernel K7 and count the launch in
    ``intersect_prims.launches``; CPU tensors run
    :func:`intersect_prims_reference`.  Any other device raises."""
    return intersect_prims_reference(prims, origins, dirs, t_max)


intersect_prims.launches = 0
