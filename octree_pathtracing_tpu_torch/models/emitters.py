"""Emissive-leaf table for next-event estimation on block lights (port of
``models/emitters.py``).

``EmitterSampling`` strategies (the JAX package's definitions):

- ``ONE``: pick one emitter by the spatial mixture pick (:func:`_spatial_pick`)
  and importance-sample one of its (up to) 3 faces that face the shading
  point (:func:`sample_emitter_point`);
- ``ONE_BLOCK``: pick one emitter uniformly and sum its 3 toward faces, one
  sampled point each (:func:`toward_face_sample`), each with
  inv_pdf = E * size^2;
- ``ALL``: the deterministic sum of that 3-face estimate over every emitter,
  refused above ``ALL_MAX_EMITTERS``.

The contribution is the area-form NEE estimator ``albedo * L_e * cos_s *
cos_e / dist^2 * inv_pdf`` with ``L_e = albedo_e^2 * emittance``, attenuated by
the shadow walk truncated at the emitter (``render/pathtracer._shade``).
With emitter sampling on, emission found by BSDF sampling counts only on
the primary bounce, so the two estimators never count a light twice.

The pick's two supercell-row gathers go through kernel P1
(``ops/gather.row_gather``).  The table is built on the host with numpy.
The cumulative sums are written as left-to-right folds, the order XLA's CPU
``cumsum`` adds in: they are CDF knife edges.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..octree.leaves import enumerate_leaves, unpack_nodes
from ..octree.node_pool import Octree
from ..ops.gather import row_gather

# Spatial-selection grid: the world is covered by a 2^GRID_BITS-per-side
# supercell grid; each cell keeps its GRID_K highest-weight emitters (weight
# = the solid-angle proxy size^2 / d^2 from the cell) with a normalised
# weight row.  The pick mixes that row with a GRID_LAMBDA uniform floor over
# all emitters, so every emitter keeps a nonzero probability everywhere and
# the mixture pdf is exact per lane.
GRID_BITS = 4
GRID_K = 8
GRID_LAMBDA = 0.25

# EmitterSampling.ALL runs 3 truncated shadow walks per emitter per diffuse
# bounce; above this many emitters the integrator refuses it.
ALL_MAX_EMITTERS = 64


@dataclasses.dataclass
class EmitterTable:
    """Flat emissive-cell table.

    pos: (E, 3) float32 — cell min corner, world voxel units.
    size: (E,) float32 — cell side (LOD-collapsed leaves are > 1).
    mat: (E,) int32 — material id.
    grid_idx: (C, K) int32 — per-supercell candidate emitter ids (or None:
        the uniform pick).
    grid_w: (C, K) float32 — normalised candidate weights (rows sum to 1).
    grid_bits / cell_size / lam: grid geometry and the uniform-mixture weight.
    """

    pos: Any
    size: Any
    mat: Any
    grid_idx: Any = None
    grid_w: Any = None
    grid_bits: int = GRID_BITS
    cell_size: float = 1.0
    lam: float = GRID_LAMBDA

    @property
    def count(self) -> int:
        return int(self.pos.shape[0])

    def to(self, device) -> "EmitterTable":
        def mv(x):
            return None if x is None else x.to(device)

        return dataclasses.replace(
            self, pos=mv(self.pos), size=mv(self.size), mat=mv(self.mat),
            grid_idx=mv(self.grid_idx), grid_w=mv(self.grid_w),
        )


def build_spatial_grid(pos: np.ndarray, size: np.ndarray, extent: float,
                       bits: int = GRID_BITS, k: int = GRID_K):
    """Host-side spatial-selection grid build.

    Per supercell, the ``k`` emitters with the largest conservative
    solid-angle proxy ``size_e^2 / d^2`` (d = distance from the cell centre,
    reduced by the cell radius, floored at the emitter size), normalised
    into a weight row; chunked over cells so the (C, E) distance matrix never
    materialises whole.  Returns (grid_idx (C, k) int32, grid_w (C, k)
    float32)."""
    e = pos.shape[0]
    k = min(k, e)
    g = 1 << bits
    cell = extent / g
    centers_e = pos + 0.5 * size[:, None]  # (E, 3)
    lin = (np.arange(g) + 0.5) * cell
    cx, cy, cz = np.meshgrid(lin, lin, lin, indexing="ij")
    cell_centers = np.stack([cx, cy, cz], -1).reshape(-1, 3)  # (C, 3)
    c_tot = cell_centers.shape[0]
    cell_rad = 0.5 * cell * np.sqrt(3.0)

    grid_idx = np.zeros((c_tot, k), np.int32)
    grid_w = np.zeros((c_tot, k), np.float32)
    sz2 = (size * size).astype(np.float64)
    chunk = max(1, int(4e6 // max(e, 1)))
    for c0 in range(0, c_tot, chunk):
        cc = cell_centers[c0 : c0 + chunk]  # (c, 3)
        d = np.linalg.norm(cc[:, None, :] - centers_e[None, :, :], axis=-1)  # (c, E)
        d = np.maximum(d - cell_rad, np.maximum(size[None, :], 1e-3))
        w = sz2[None, :] / (d * d)  # (c, E)
        if k < e:
            top = np.argpartition(-w, k - 1, axis=1)[:, :k]
        else:
            top = np.broadcast_to(np.arange(e), (w.shape[0], e)).copy()
        tw = np.take_along_axis(w, top, axis=1)
        order = np.argsort(-tw, axis=1)  # descending, for short CDF reads
        top = np.take_along_axis(top, order, axis=1)
        tw = np.take_along_axis(tw, order, axis=1)
        grid_idx[c0 : c0 + chunk] = top
        grid_w[c0 : c0 + chunk] = tw / np.maximum(tw.sum(axis=1, keepdims=True), 1e-30)
    return grid_idx, grid_w


def _cumsum_fold(x):
    """Cumulative sum along the last axis as a left-to-right fold."""
    cols = [x[:, 0]]
    for i in range(1, x.shape[1]):
        cols.append(cols[-1] + x[:, i])
    return torch.stack(cols, dim=1)


def _spatial_pick(em: EmitterTable, p, u_pick):
    """Spatially weighted emitter pick; returns (idx (B,) int32, inv_p (B,)).

    With probability ``lam`` the pick is uniform over all E; otherwise it
    draws from the shading point's supercell candidate row by weight.  The
    realised pdf is exact per lane, by a K-wide membership test:
    ``p = lam / E + (1 - lam) * w_row[match]``."""
    e = em.pos.shape[0]
    if em.grid_idx is None:
        idx = torch.clamp((u_pick * e).to(torch.int32), max=e - 1)
        return idx, torch.full_like(u_pick, float(e))
    g = 1 << em.grid_bits
    lam = em.lam
    cell = torch.clamp((p / em.cell_size).to(torch.int32), 0, g - 1)  # (B, 3)
    c = (cell[:, 0] * g + cell[:, 1]) * g + cell[:, 2]
    gi = row_gather(em.grid_idx, c)  # (B, K) small-table gathers: kernel P1
    gw = row_gather(em.grid_w, c)

    uni = u_pick < lam
    u_u = torch.clamp(u_pick / lam, 0.0, 1.0 - 1e-7)
    idx_u = torch.clamp((u_u * e).to(torch.int32), max=e - 1)
    u_s = torch.clamp((u_pick - lam) / (1.0 - lam), 0.0, 1.0 - 1e-7)
    cdf = _cumsum_fold(gw)
    j = (u_s[:, None] > cdf).to(torch.int32).sum(dim=1)
    j = torch.clamp(j, max=gi.shape[1] - 1)
    idx_s = torch.gather(gi, 1, j[:, None].long())[:, 0]
    idx = torch.where(uni, idx_u, idx_s)
    w_match = torch.where(gi == idx[:, None], gw, 0.0).sum(dim=1)
    p_pick = lam / e + (1.0 - lam) * w_match
    return idx, 1.0 / p_pick


def sample_emitter_point(em: EmitterTable, p, u_pick, u1, u2, n=None):
    """Sample (emitter, surface point) from the table toward shading point p.

    ``n``: optional (B, 3) shading normal; the supercell lookup then uses
    ``p + 0.01 * cell_size * n``, which moves a point lying on a voxel face
    (a grid-cell boundary plane) decisively into the open cell in front of
    it.  The face is importance-sampled among the (up to) 3 faces oriented
    toward ``p``, weighted by the cosine of the face normal against the
    cell -> p direction; ``u1`` picks the face by cumulative weight and is
    rescaled within the chosen bin for the first in-face coordinate, ``u2``
    is the second.

    Returns dict(q (B, 3) point, ne (B, 3) outward face normal, mat (B,)
    int32, uv (B, 2) in-face coordinates, inv_pdf (B,) = size^2 / p_pick *
    sum(w) / w_axis)."""
    p_cell = p if n is None else p + (0.01 * em.cell_size) * n
    idx, pick_inv = _spatial_pick(em, p_cell, u_pick)
    il = idx.long()
    pos = em.pos[il]  # (B, 3)
    size = em.size[il]  # (B,)
    mat = em.mat[il]

    center = pos + 0.5 * size[:, None]
    dpc = p - center  # (B, 3)
    sq = dpc * dpc
    dn = torch.sqrt(torch.clamp((sq[:, 0] + sq[:, 1]) + sq[:, 2], min=1e-12))
    w = torch.abs(dpc) / dn[:, None] + 1e-6  # (B, 3) cosine face weights
    csum = _cumsum_fold(w)
    total = csum[:, 2]
    r = u1 * total
    axis = torch.where(r < csum[:, 0], 0, torch.where(r < csum[:, 1], 1, 2))
    onehot = torch.arange(3, dtype=torch.int64, device=p.device)[None, :]
    sel_axis = onehot == axis[:, None]
    w_a = torch.where(sel_axis, w, 0.0).sum(dim=1)
    lo = torch.where(axis == 0, 0.0, torch.where(axis == 1, csum[:, 0], csum[:, 1]))
    a = torch.clamp((r - lo) / w_a, 0.0, 1.0)  # rescaled in-bin coordinate
    b = u2
    hi = (torch.where(sel_axis, dpc, 0.0).sum(dim=1) > 0.0).to(torch.float32)

    # in-face (a, b) map to the two other coordinates with the (axis + 1,
    # axis + 2) mod 3 convention of the traversal's uv
    sel_1 = onehot == ((axis + 1) % 3)[:, None]
    sel_2 = onehot == ((axis + 2) % 3)[:, None]
    coord = sel_axis * (hi * size)[:, None] + sel_1 * (a * size)[:, None] + sel_2 * (b * size)[:, None]
    q = pos + coord
    ne = torch.where(sel_axis, (2.0 * hi - 1.0)[:, None], 0.0)
    inv_pdf = pick_inv * size * size * total / w_a
    return dict(q=q, ne=ne, mat=mat, uv=torch.stack([a, b], -1), inv_pdf=inv_pdf)


def toward_face_sample(pos, size, p, axis: int, u1, u2):
    """Point on the emitter face of ``axis`` oriented toward ``p``: for a
    convex cell exactly the 3 faces whose axis sign matches the cell -> p
    direction can contribute, so summing the per-axis toward faces is the
    whole-surface sum.  The point is uniform on the face (pdf 1 / size^2);
    ``u1`` / ``u2`` are the in-face coordinates.

    pos: (B, 3) cell min corner; size: (B,); p: (B, 3) shading point.
    Returns (q (B, 3), ne (B, 3) outward normal, uv (B, 2))."""
    center_ax = pos[:, axis] + 0.5 * size
    hi = (p[:, axis] - center_ax > 0.0).to(torch.float32)
    onehot = torch.arange(3, device=p.device)[None, :]
    sel_axis = onehot == axis
    sel_1 = onehot == (axis + 1) % 3
    sel_2 = onehot == (axis + 2) % 3
    coord = sel_axis * (hi * size)[:, None] + sel_1 * (u1 * size)[:, None] + sel_2 * (u2 * size)[:, None]
    q = pos + coord
    ne = torch.where(sel_axis, (2.0 * hi - 1.0)[:, None], 0.0)
    return q, ne, torch.stack([u1, u2], -1)


def leaf_emissive_material(leaf_values, leaf_material, emittance) -> np.ndarray:
    """Emissive material id per leaf value (-1 = not emissive): leaf value ->
    material, kept when its emittance is above 1e-6 (no block models in this
    port)."""
    emitt = np.asarray(emittance)
    lv = np.asarray(leaf_values, np.int64)
    lm = np.asarray(leaf_material, np.int64)
    mats = lm[np.clip(lv, 0, len(lm) - 1)]
    return np.where(emitt[mats] > 1e-6, mats, -1)


def build_emitter_table(octree, leaf_material, materials) -> EmitterTable | None:
    """Collect the emissive leaf cells of a numpy ``Octree`` (anything with
    ``child_mask``, ``child_data``, ``root`` and ``depth``) into a CPU
    :class:`EmitterTable` with its spatial grid; None when there are none."""
    pos, size, val = enumerate_leaves(octree.child_mask, octree.child_data, octree.root, octree.depth)
    if val.size == 0:
        return None
    mats = leaf_emissive_material(
        val, torch.as_tensor(leaf_material).cpu().numpy(), materials.emittance.detach().cpu().numpy()
    )
    keep = mats >= 0
    if not keep.any():
        return None
    pos_k = pos[keep].astype(np.float32)
    size_k = size[keep].astype(np.float32)
    extent = float(1 << octree.depth)
    g_idx, g_w = build_spatial_grid(pos_k, size_k, extent)
    return EmitterTable(
        pos=torch.from_numpy(pos_k),
        size=torch.from_numpy(size_k),
        mat=torch.from_numpy(mats[keep].astype(np.int32)),
        grid_idx=torch.from_numpy(g_idx),
        grid_w=torch.from_numpy(g_w),
        grid_bits=GRID_BITS,
        cell_size=extent / (1 << GRID_BITS),
        lam=GRID_LAMBDA,
    )


def with_emitter_sampling(scene, name: str):
    """``scene`` under the CLI's ``--emitter-sampling name``: ``scene`` keeps
    the scene's own strategy, ``none`` turns emitter sampling off, and
    ``one`` / ``one_block`` / ``all`` (the ``EmitterSampling`` values) turn
    it on, building the table from the packed node table when the scene has
    none."""
    if name == "scene":
        return scene
    if name == "none":
        return dataclasses.replace(scene, emitter_sampling=name)
    em = scene.emitters
    if em is None:
        mask, data = unpack_nodes(scene.nodes.cpu().numpy())
        tree = Octree(mask, data, scene.root, scene.depth)
        em = build_emitter_table(tree, scene.leaf_material, scene.materials)
        em = None if em is None else em.to(scene.device)
    return dataclasses.replace(scene, emitter_sampling=name, emitters=em)
