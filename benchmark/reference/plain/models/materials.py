"""Material table — structure of arrays, one tensor per field (port of
``models/materials.py``).  Flags keep the reference's bit layout; material
id 0 is AIR (ior 1.000293, no flags, default texture)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FLAG_OPAQUE = 0x01
FLAG_SUBSURFACE_SCATTER = 0x02
FLAG_REFRACTIVE = 0x04
FLAG_WATERLOGGED = 0x08
FLAG_SOLID = 0x10

DEFAULT_IOR = 1.000293

_FIELDS = (
    "ior",
    "specular",
    "emittance",
    "roughness",
    "metalness",
    "flags",
    "texture_index",
    "tint_index",
)


@dataclasses.dataclass
class MaterialTable:
    ior: torch.Tensor  # (M,) f32
    specular: torch.Tensor  # (M,) f32
    emittance: torch.Tensor  # (M,) f32
    roughness: torch.Tensor  # (M,) f32
    metalness: torch.Tensor  # (M,) f32
    flags: torch.Tensor  # (M,) int32 (the JAX table's uint32 bits)
    texture_index: torch.Tensor  # (M,) int32 — atlas layer
    tint_index: torch.Tensor  # (M,) int32

    @property
    def count(self) -> int:
        return int(self.ior.shape[0])

    def to(self, device) -> "MaterialTable":
        return MaterialTable(*(getattr(self, f).to(device) for f in _FIELDS))


def make_material_table(materials: list[dict]) -> MaterialTable:
    """Build a table from dicts; index 0 should be AIR (use :func:`air`)."""

    def col(key, default, dtype=np.float32):
        return torch.from_numpy(np.array([m.get(key, default) for m in materials], dtype=dtype))

    return MaterialTable(
        ior=col("ior", DEFAULT_IOR),
        specular=col("specular", 0.0),
        emittance=col("emittance", 0.0),
        roughness=col("roughness", 0.0),
        metalness=col("metalness", 0.0),
        flags=col("flags", FLAG_OPAQUE | FLAG_SOLID, np.int32),
        texture_index=col("texture_index", 0, np.int32),
        tint_index=col("tint_index", 0, np.int32),
    )


def gather_rows(m: MaterialTable, mat) -> dict:
    """Every per-material scalar of ``mat`` (B,) as a dict of (B,) columns."""
    idx = mat.long()
    return dict(
        ior=m.ior[idx],
        specular=m.specular[idx],
        emittance=m.emittance[idx],
        roughness=m.roughness[idx],
        metalness=m.metalness[idx],
        flags=m.flags[idx],
        texture_index=m.texture_index[idx],
    )


def air() -> dict:
    """Material id 0."""
    return dict(ior=DEFAULT_IOR, flags=0, texture_index=0)


def has_flag(flags, bit):
    """Whether each of ``flags`` has ``bit`` set."""
    return (flags & bit) != 0
