"""Geometry primitives: AABB slabs, quads, spheres, cube-face normals (port
of ``ops/geometry.py``), as plain functions on tensors.

Rounding.  The JAX package's CPU path (XLA, LLVM) contracts a multiply that
feeds an add into one fused multiply-add: ``a*b + c`` rounds once, a dot
product is ``fma(a2, b2, fma(a1, b1, a0*b0))``, a cross product component
``fma(a1, b2, -(a2*b1))``.  These functions round the same way through
:func:`fma`, so that they equal the JAX functions on the CPU
(``tests/test_torch_geometry.py``) and the CUDA kernels that repeat this
arithmetic equal them bit for bit on the card (``csrc/quads.cuh``, the
quad scan of ``csrc/traversal.cu`` and the primitive scan of
``csrc/prims.cu`` compute the same float64 steps, built without FMA
contraction).  Only the sphere's uv divides by a Python number (see
:func:`sphere_hit`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EPSILON = 5e-8  # Ray::EPSILON


def fma(a, b, c):
    """``a * b + c`` in float32 with one rounding, as a fused multiply-add
    gives it: the product of two float32 values is exact in float64, and the
    float64 sum rounds to float32 (a second rounding that could differ from
    a true fused one only where the float64 sum falls exactly between two
    float32 values)."""
    return (a.double() * b.double() + c.double()).float()


def _sqrt(x):
    """Correctly rounded float32 square root (torch's CPU kernel is not; the
    float64 root rounded to float32 is, as is CUDA's ``sqrtf``)."""
    return torch.sqrt(x.double()).float()


def _dot(a, b):
    """Last-axis dot product of (..., 3) tensors: ``fma(a2, b2, fma(a1, b1,
    a0*b0))``."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _cross(a, b):
    """Last-axis cross product of (..., 3) tensors, each component
    ``fma(x, y, -(z*w))``."""
    return torch.stack(
        [
            fma(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
            fma(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
            fma(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0])),
        ],
        dim=-1,
    )


def aabb_intersect(box_min, box_max, origins, inv_dirs):
    """Branchless slab test: returns (t0, t1); a hit iff t0 <= t1 (and
    t1 > 0 for a forward hit)."""
    t_bot = (box_min - origins) * inv_dirs
    t_top = (box_max - origins) * inv_dirs
    t0 = torch.minimum(t_bot, t_top).amax(dim=-1)
    t1 = torch.maximum(t_bot, t_top).amin(dim=-1)
    return t0, t1


class QuadSoA(NamedTuple):
    """Quad table with the derived w, normal and d precomputed."""

    origin: torch.Tensor  # (Q, 3) float32
    u: torch.Tensor  # (Q, 3)
    v: torch.Tensor  # (Q, 3)
    w: torch.Tensor  # (Q, 3)  n / (n . n)
    normal: torch.Tensor  # (Q, 3) unit
    d: torch.Tensor  # (Q,)
    material_id: torch.Tensor  # (Q,) int32
    tex_u_range: torch.Tensor  # (Q, 2)
    tex_v_range: torch.Tensor  # (Q, 2)

    @property
    def count(self) -> int:
        return int(self.origin.shape[0])

    def to(self, device) -> "QuadSoA":
        return QuadSoA(*(x.to(device) for x in self))


def _f32(x):
    # C order whatever the input's strides (a broadcast default range too):
    # the kernels read the tables as dense rows
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def make_quads(origins, us, vs, material_ids, tex_u_ranges=None, tex_v_ranges=None) -> QuadSoA:
    """Batch constructor (``Quad::new``): normal = n / |n|, w = n / (n . n)
    and d = normal . origin with n = u x v."""
    origins, us, vs = _f32(origins), _f32(us), _f32(vs)
    q = origins.shape[0]
    n = _cross(us, vs)
    nn = _dot(n, n)[:, None]
    normal = n / _sqrt(nn)
    w = n / nn
    d = _dot(normal, origins)
    if tex_u_ranges is None:
        tex_u_ranges = np.broadcast_to(np.array([0.0, 1.0], np.float32), (q, 2))
    if tex_v_ranges is None:
        tex_v_ranges = np.broadcast_to(np.array([0.0, 1.0], np.float32), (q, 2))
    return QuadSoA(
        origin=origins,
        u=us,
        v=vs,
        w=w.contiguous(),
        normal=normal.contiguous(),
        d=d.contiguous(),
        material_id=torch.as_tensor(np.asarray(material_ids, np.int32)).contiguous(),
        tex_u_range=_f32(tex_u_ranges),
        tex_v_range=_f32(tex_v_ranges),
    )


def quad_hit(quads: QuadSoA, q_idx, ray_origin, ray_dir, voxel_pos, t_next):
    """Batched ``Quad::hit`` against one quad per lane (``q_idx`` (B,)).

    Returns (hit (B,), t (B,), uu (B,), vv (B,)): a backface (denom >=
    -EPSILON) misses, and so does a crossing outside [0, 1]^2 in (alpha,
    beta) or outside (0, t_next]."""
    qi = q_idx.long()
    qo, qu, qv, qw = quads.origin[qi], quads.u[qi], quads.v[qi], quads.w[qi]
    qn, qd = quads.normal[qi], quads.d[qi]

    tro = ray_origin - voxel_pos
    denom = _dot(ray_dir, qn)
    t = (qd - _dot(qn, tro)) / denom
    inter = fma(ray_dir, t[:, None], tro)
    p = inter - qo
    alpha = _dot(qw, _cross(p, qv))
    beta = _dot(qw, _cross(qu, p))
    ok = (
        (denom < -EPSILON)
        & (t > 0.0)
        & (t <= t_next)
        & (alpha >= 0.0)
        & (alpha <= 1.0)
        & (beta >= 0.0)
        & (beta <= 1.0)
    )
    ur, vr = quads.tex_u_range[qi], quads.tex_v_range[qi]
    uu = fma(alpha, ur[:, 1] - ur[:, 0], ur[:, 0])
    vv = fma(beta, vr[:, 1] - vr[:, 0], vr[:, 0])
    return ok, t, uu, vv


def sphere_hit(center, radius, origins, dirs):
    """Quadratic sphere intersection with lat/long uv; the nearest root
    beyond EPSILON.  ``center`` (3,) and ``radius`` () are tensors.

    Returns (hit (B,), t (B,) inf on a miss, uv (B, 2), normal (B, 3))."""
    oc = center - origins
    a = _dot(dirs, dirs)
    h = _dot(dirs, oc)
    cc = fma(-radius, radius, _dot(oc, oc))
    disc = fma(h, h, -(a * cc))
    sq = _sqrt(torch.clamp(disc, min=0.0))
    t0 = (h - sq) / a
    t1 = (h + sq) / a
    t = torch.where(t0 > EPSILON, t0, t1)
    hit = (disc >= 0.0) & (t > EPSILON)
    point = fma(dirs, t[:, None], origins)
    normal = (point - center) / radius
    theta = torch.acos(torch.clamp(-normal[:, 1], -1.0, 1.0))
    # the uv's divisions by constants may round an ulp apart from the
    # kernel's (PyTorch multiplies a CUDA tensor by the reciprocal)
    phi = torch.atan2(-normal[:, 2], normal[:, 0]) + np.pi
    uv = torch.stack([phi / (2 * np.pi), theta / np.pi], dim=-1)
    return hit, torch.where(hit, t, float("inf")), uv, normal


FACE_NORMALS = np.array(
    [[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]],
    np.float32,
)


def face_normal(face_id):
    """face id -> outward normal of the entered face."""
    table = torch.as_tensor(FACE_NORMALS, device=face_id.device)
    return table[torch.clamp(face_id.long(), 0, 5)]
