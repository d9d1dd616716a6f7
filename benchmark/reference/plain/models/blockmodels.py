"""Block model tables: non-cube geometry inside voxels (port of
``models/blockmodels.py``).

- leaf value -> model id;
- a model is SIMPLE (a full cube with 6 per-face materials) or a range of
  up to ``MAX_MODEL_QUADS`` quads in a shared :class:`QuadSoA`, in
  block-local [0, 1]^3 coordinates (cross plants, slabs, torch shafts);
- a traversal candidate on a quad model counts only where one of its quads
  is hit at a texel of alpha above EPSILON; otherwise the walk goes on (the
  quad-model accept, kernel K2q of ``csrc/traversal.cu``).

The tables are built on the host with numpy and held as CPU tensors;
``BlockModels.to(device)`` moves them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.geometry import QuadSoA, make_quads
from ..ops.traversal import FLAG_SIMPLE, MAX_MODEL_QUADS  # noqa: F401 -- the model layer's names


@dataclasses.dataclass
class BlockModels:
    leaf_model: torch.Tensor  # (L,) int32: leaf value -> model id
    flags: torch.Tensor  # (M,) int32
    face_material: torch.Tensor  # (M, 6) int32: per-face materials of simple models
    quad_start: torch.Tensor  # (M,) int32
    quad_count: torch.Tensor  # (M,) int32
    quads: QuadSoA  # block-local quads of the quad models

    def to(self, device) -> "BlockModels":
        return BlockModels(
            leaf_model=self.leaf_model.to(device),
            flags=self.flags.to(device),
            face_material=self.face_material.to(device),
            quad_start=self.quad_start.to(device),
            quad_count=self.quad_count.to(device),
            quads=self.quads.to(device),
        )


def _i32(x):
    return torch.as_tensor(np.asarray(x, np.int32)).contiguous()


class ModelBuilder:
    """Accumulates models and their quads on the host."""

    def __init__(self):
        self.flags: list[int] = []
        self.face_material: list[list[int]] = []
        self.quad_start: list[int] = []
        self.quad_count: list[int] = []
        self._qo: list = []
        self._qu: list = []
        self._qv: list = []
        self._qm: list = []
        self._qur: list = []
        self._qvr: list = []

    def add_simple(self, face_materials) -> int:
        """Full-cube model; ``face_materials``: one id or 6 per-face ids."""
        if np.isscalar(face_materials):
            face_materials = [int(face_materials)] * 6
        mid = len(self.flags)
        self.flags.append(FLAG_SIMPLE)
        self.face_material.append([int(x) for x in face_materials])
        self.quad_start.append(0)
        self.quad_count.append(0)
        return mid

    def add_quad_model(self, quads: list[dict]) -> int:
        """Quad-list model; each quad: {origin, u, v, material, [uv_range]}
        in block-local [0, 1]^3 coordinates."""
        if not 0 < len(quads) <= MAX_MODEL_QUADS:
            raise ValueError(f"a quad model holds 1..{MAX_MODEL_QUADS} quads, not {len(quads)}")
        mid = len(self.flags)
        self.flags.append(0)
        self.face_material.append([int(quads[0]["material"])] * 6)
        self.quad_start.append(len(self._qo))
        self.quad_count.append(len(quads))
        for q in quads:
            self._qo.append(q["origin"])
            self._qu.append(q["u"])
            self._qv.append(q["v"])
            self._qm.append(int(q["material"]))
            ur, vr = q.get("uv_range", ((0.0, 1.0), (0.0, 1.0)))
            self._qur.append(ur)
            self._qvr.append(vr)
        return mid

    def build(self, leaf_model) -> BlockModels:
        if not self._qo:  # a dummy quad keeps the table non-empty
            self._qo = [[0.0, 0.0, 0.0]]
            self._qu = [[1.0, 0.0, 0.0]]
            self._qv = [[0.0, 1.0, 0.0]]
            self._qm = [0]
            self._qur = [(0.0, 1.0)]
            self._qvr = [(0.0, 1.0)]
        quads = make_quads(self._qo, self._qu, self._qv, self._qm, self._qur, self._qvr)
        return BlockModels(
            leaf_model=_i32(leaf_model),
            flags=_i32(self.flags),
            face_material=_i32(self.face_material),
            quad_start=_i32(self.quad_start),
            quad_count=_i32(self.quad_count),
            quads=quads,
        )


def cross_plant_quads(material: int, inset: float = 0.15) -> list[dict]:
    """The X-shaped plant model: two double-sided diagonal quads as four
    single-sided ones."""
    a, b = inset, 1.0 - inset
    return [
        dict(origin=[a, 0.0, a], u=[b - a, 0.0, b - a], v=[0.0, 1.0, 0.0], material=material),
        dict(origin=[b, 0.0, b], u=[a - b, 0.0, a - b], v=[0.0, 1.0, 0.0], material=material),
        dict(origin=[a, 0.0, b], u=[b - a, 0.0, a - b], v=[0.0, 1.0, 0.0], material=material),
        dict(origin=[b, 0.0, a], u=[a - b, 0.0, b - a], v=[0.0, 1.0, 0.0], material=material),
    ]


def slab_quads(material: int, height: float = 0.5) -> list[dict]:
    """Bottom slab: the top face, the bottom face and 4 sides of height
    ``height``."""
    h = height
    return [
        dict(origin=[0.0, h, 0.0], u=[0.0, 0.0, 1.0], v=[1.0, 0.0, 0.0], material=material),
        dict(origin=[0.0, 0.0, 0.0], u=[1.0, 0.0, 0.0], v=[0.0, 0.0, 1.0], material=material),
        dict(origin=[0.0, 0.0, 0.0], u=[0.0, 0.0, 1.0], v=[0.0, h, 0.0], material=material),
        dict(origin=[1.0, 0.0, 1.0], u=[0.0, 0.0, -1.0], v=[0.0, h, 0.0], material=material),
        dict(origin=[1.0, 0.0, 0.0], u=[-1.0, 0.0, 0.0], v=[0.0, h, 0.0], material=material),
        dict(origin=[0.0, 0.0, 1.0], u=[1.0, 0.0, 0.0], v=[0.0, h, 0.0], material=material),
    ]
