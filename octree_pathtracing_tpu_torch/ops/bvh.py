"""Flat BVH: the host SAH build and the ordered stack walk over quads (port
of ``ops/bvh.py``).

:func:`build_bvh` is a copy of the JAX package's host build (a full SAH
sweep over every axis and split, leaves of at most ``leaf_size``
primitives) and gives the same arrays.  The JAX walk, ``bvh_intersect``,
takes a Python callback per primitive; a kernel cannot, and the only
callback the JAX package passes is ``quad_hit`` with the quad id as the
payload.  So the port has two entry points:

- :func:`bvh_intersect_quads` walks a BVH over a world-space
  :class:`~.geometry.QuadSoA`: CUDA tensors launch kernel K8
  (``csrc/bvh.cu``, one thread per ray, its stack in shared memory) and
  count the launch in ``bvh_intersect_quads.launches``; CPU tensors run the
  twin.  There is no fallback from one to the other: a tree deeper than
  the kernel's stack (``STACK_CAPACITY`` entries a ray, the tree's depth
  + 1 needed) is refused.
- :func:`bvh_intersect_reference` is the plain-torch twin in the JAX
  callback form, one stack per lane; :func:`quad_prim_fn` gives it the quad
  callback (``geometry.quad_hit``, whose fused rounding equals the JAX CPU
  path's and the kernel's).

The walk, as the JAX one: the inverse direction takes +1e-12 where
``|d| < 1e-12``; a node's box counts where ``t0 <= t1``, ``t1 > 0`` and
``t0 < t_best`` (strict); a leaf tests at most its first 2 primitives,
whatever ``leaf_size`` was, and takes a hit where ``t < t_best``; an
interior node pushes the far child, then the near one (the child box
entered first, ties to the left), so the near one pops first.  The stack
holds ``MAX_STACK`` entries: pushes beyond it are dropped, and a pop beyond
it reads the last entry (the JAX walk's gather differs there; no tree of
the port comes near that depth, see :func:`tree_depth`).  The kernel makes
the same decisions on the same floats, but reads each node row once: a
parent slab-tests both children fully and carries what a child's visit
needs, so a pop reads no row (``csrc/bvh.cu``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from functools import cached_property

import numpy as np
import torch

from ..utils.cuda_build import on_current_stream
from .geometry import QuadSoA, QuadTable, quad_hit

MAX_STACK = 64
LEAF_FLAG = 1 << 30
# entries per ray that K8's stack in shared memory can hold (csrc/bvh.cu
# kMaxStack): a walk of a tree of depth D needs at most D + 1
STACK_CAPACITY = 64


@dataclasses.dataclass
class BVH:
    node_min: torch.Tensor  # (N, 3) float32
    node_max: torch.Tensor  # (N, 3) float32
    left: torch.Tensor  # (N,) int32: left child, or LEAF_FLAG | first primitive
    right: torch.Tensor  # (N,) int32: right child, or a leaf's primitive count
    prim_order: torch.Tensor  # (P,) int32: primitive permutation
    # (N, 8) float32 rows [min xyz, left's bits, max xyz, right's bits]: the
    # kernel reads a node as two 16-byte loads
    rows: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return int(self.left.shape[0])

    @cached_property
    def depth(self) -> int:
        """:func:`tree_depth`, computed once per BVH (and kept by :meth:`to`)."""
        return tree_depth(self)

    @classmethod
    def from_arrays(cls, node_min, node_max, left, right, prim_order) -> "BVH":
        node_min = torch.as_tensor(np.asarray(node_min, np.float32))
        node_max = torch.as_tensor(np.asarray(node_max, np.float32))
        left = torch.as_tensor(np.asarray(left, np.int32))
        right = torch.as_tensor(np.asarray(right, np.int32))
        rows = torch.cat([node_min, left.view(torch.float32)[:, None],
                          node_max, right.view(torch.float32)[:, None]], dim=1).contiguous()
        return cls(node_min, node_max, left, right, torch.as_tensor(np.asarray(prim_order, np.int32)), rows)

    def to(self, device) -> "BVH":
        moved = BVH(*(x.to(device) for x in dataclasses.astuple(self)))
        if "depth" in self.__dict__:
            moved.depth = self.depth
        return moved


def build_bvh(prim_min: np.ndarray, prim_max: np.ndarray, leaf_size: int = 2) -> BVH:
    """Full-sweep SAH build on the host (numpy): a copy of the JAX package's
    ``build_bvh``."""
    p = prim_min.shape[0]
    centroid = (prim_min + prim_max) * 0.5
    order = np.arange(p)

    node_min, node_max, left, right = [], [], [], []

    def area(mn, mx):
        e = np.maximum(mx - mn, 0)
        return 2.0 * (e[..., 0] * e[..., 1] + e[..., 0] * e[..., 2] + e[..., 1] * e[..., 2])

    def build(idx):
        node_id = len(node_min)
        mn = prim_min[idx].min(axis=0)
        mx = prim_max[idx].max(axis=0)
        node_min.append(mn)
        node_max.append(mx)
        left.append(0)
        right.append(0)
        if len(idx) <= leaf_size:
            start = build.prim_cursor
            build.order_out[start : start + len(idx)] = idx
            build.prim_cursor += len(idx)
            left[node_id] = LEAF_FLAG | start
            right[node_id] = len(idx)
            return node_id
        # full SAH sweep over each axis
        best = (np.inf, None, None)
        for axis in range(3):
            o = idx[np.argsort(centroid[idx, axis], kind="stable")]
            lmn = np.minimum.accumulate(prim_min[o], axis=0)
            lmx = np.maximum.accumulate(prim_max[o], axis=0)
            rmn = np.minimum.accumulate(prim_min[o][::-1], axis=0)[::-1]
            rmx = np.maximum.accumulate(prim_max[o][::-1], axis=0)[::-1]
            n = len(o)
            counts = np.arange(1, n)
            cost = area(lmn[:-1], lmx[:-1]) * counts + area(rmn[1:], rmx[1:]) * (n - counts)
            k = int(np.argmin(cost))
            if cost[k] < best[0]:
                best = (cost[k], o[: k + 1], o[k + 1 :])
        _, li, ri = best
        if li is None or len(li) == 0 or len(ri) == 0:
            half = len(idx) // 2
            li, ri = idx[:half], idx[half:]
        lid = build(li)
        rid = build(ri)
        left[node_id] = lid
        right[node_id] = rid
        return node_id

    build.prim_cursor = 0
    build.order_out = np.zeros(p, np.int64)
    build(order)
    return BVH.from_arrays(np.stack(node_min), np.stack(node_max), left, right, build.order_out)


def tree_depth(bvh: BVH) -> int:
    """The number of nodes on the longest root-to-leaf path (the walk's
    stack holds at most one entry per level, plus one)."""
    left, right = bvh.left.cpu().numpy(), bvh.right.cpu().numpy()
    depth, level, frontier = 0, 0, np.zeros(1, np.int64)
    while frontier.size:
        level += 1
        depth = level
        inner = frontier[(left[frontier] & LEAF_FLAG) == 0]
        frontier = np.concatenate([left[inner], right[inner]]).astype(np.int64)
    return depth


def quad_prim_fn(quads: QuadSoA):
    """The quad callback of :func:`bvh_intersect_reference`: ``quad_hit`` of
    quad ``pid`` in world space, up to ``t_best``, with the quad id as the
    payload."""

    def prim_fn(pid, origins, dirs, t_best):
        ok, t, _, _ = quad_hit(quads, pid, origins, dirs, torch.zeros_like(origins), t_best)
        return ok, t, pid

    return prim_fn


def _entry(mn, mx, origins, inv):
    """Slab test of one box per lane: (t0, t1)."""
    t_bot = (mn - origins) * inv
    t_top = (mx - origins) * inv
    return torch.minimum(t_bot, t_top).amax(dim=-1), torch.maximum(t_bot, t_top).amin(dim=-1)


def bvh_intersect_reference(bvh: BVH, origins, dirs, prim_hit_fn, t_init=None, stats: dict | None = None):
    """Plain-torch twin of kernel K8 (any device), in the JAX callback form.

    ``prim_hit_fn(prim_id, origins, dirs, t_best) -> (hit, t, payload)``
    tests one primitive per lane.  Returns (hit (B,), t (B,), payload (B,)
    int32): hit where a primitive was taken; t is ``t_init`` (inf when None)
    on a miss.  ``stats``, where given, gains the walk's work: ``nodes``
    (node rows fetched), ``interior`` (interior nodes whose box was hit:
    each reads its two children's boxes) and ``prims`` (primitives tested)."""
    b = origins.shape[0]
    dev = origins.device
    inv = 1.0 / torch.where(dirs.abs() < 1e-12, 1e-12, dirs)
    t_best = torch.full((b,), float("inf"), device=dev) if t_init is None else t_init.clone()
    payload = torch.full((b,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((b, MAX_STACK), dtype=torch.int64, device=dev)
    sp = torch.ones((b,), dtype=torch.int64, device=dev)
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    lanes = torch.arange(b, device=dev)
    node_min, node_max = bvh.node_min, bvh.node_max
    left, right = bvh.left.long(), bvh.right.long()
    n_prims = bvh.prim_order.shape[0]
    work = {"nodes": 0, "interior": 0, "prims": 0}

    while bool(active.any()):
        sp_new = sp - 1
        node = torch.where(active, stack[lanes, sp_new.clamp(0, MAX_STACK - 1)], 0)
        t0, t1 = _entry(node_min[node], node_max[node], origins, inv)
        proc = active & (t0 <= t1) & (t1 > 0.0) & (t0 < t_best)
        lw, rw = left[node], right[node]
        is_leaf = (lw & LEAF_FLAG) != 0

        # a leaf tests its first primitives, at most two
        start = lw & ~LEAF_FLAG
        for k in range(2):
            pid = bvh.prim_order[(start + k).clamp(0, n_prims - 1)]
            valid = proc & is_leaf & (k < rw)
            hit_k, t_k, pay_k = prim_hit_fn(pid, origins, dirs, t_best)
            take = valid & hit_k & (t_k < t_best)
            t_best = torch.where(take, t_k, t_best)
            payload = torch.where(take, pay_k.to(torch.int32), payload)
            work["prims"] += int(valid.sum())

        # an interior node pushes the far child, then the near one
        push = proc & ~is_leaf
        lc, rc = torch.where(is_leaf, 0, lw), torch.where(is_leaf, 0, rw)
        lt0 = _entry(node_min[lc], node_max[lc], origins, inv)[0]
        rt0 = _entry(node_min[rc], node_max[rc], origins, inv)[0]
        near_is_left = lt0 <= rt0
        near = torch.where(near_is_left, lc, rc)
        far = torch.where(near_is_left, rc, lc)
        for slot, child in ((sp_new, far), (sp_new + 1, near)):
            put = push & (slot < MAX_STACK)  # a push beyond the stack is dropped
            stack[lanes[put], slot[put]] = child[put]
        work["nodes"] += int(active.sum())
        work["interior"] += int(push.sum())
        sp = torch.where(active, torch.where(push, sp_new + 2, sp_new), sp)
        active = active & (sp > 0)

    if stats is not None:
        for key, n in work.items():
            stats[key] = stats.get(key, 0) + n
    return payload >= 0, t_best, payload


@functools.cache
def _library():
    """K8's shared library, built at first use."""
    from ..utils.cuda_build import load_library

    # no FMA contraction: the twin rounds every multiply and add on its own
    lib = load_library("bvh", ("-fmad=false",))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bvh_intersect.argtypes = [vp, vp, ci, ctypes.POINTER(QuadTable), vp, vp, vp, ci, ci, vp, vp, vp, vp]
    lib.bvh_intersect.restype = ci
    lib.bvh_intersect_attributes.argtypes = [ci, ctypes.POINTER(ci)]
    lib.bvh_intersect_attributes.restype = ci
    lib.bvh_error_string.argtypes = [ci]
    lib.bvh_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(bvh: BVH, quads: QuadSoA, origins, dirs, t_init):
    b = origins.shape[0]
    dev = origins.device
    tensors = [origins, dirs, bvh.rows, bvh.prim_order, *quads] + ([] if t_init is None else [t_init])
    checks = [
        (origins.dtype == torch.float32 and origins.shape == (b, 3), "origins must be (B, 3) float32"),
        (dirs.dtype == torch.float32 and dirs.shape == (b, 3), "dirs must be (B, 3) float32"),
        (t_init is None or (t_init.dtype == torch.float32 and t_init.shape == (b,)), "t_init must be (B,) float32"),
        (all(x.is_contiguous() and x.device == dev for x in tensors),
         "rays, BVH and quads must be contiguous and on one device"),
        (bvh.rows.dtype == torch.float32 and bvh.rows.dim() == 2 and bvh.rows.shape[1] == 8,
         "BVH rows must be (N, 8) float32"),
        (bvh.prim_order.dtype == torch.int32 and bvh.prim_order.numel() > 0, "prim_order must be non-empty int32"),
        (b < 2**31, "too many rays for one launch"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"bvh_intersect_quads: {msg}")


def stack_entries(bvh: BVH) -> int:
    """The stack entries per ray K8 launches ``bvh`` with: its depth + 1.
    Raises where that exceeds ``STACK_CAPACITY``."""
    entries = bvh.depth + 1
    if entries > STACK_CAPACITY:
        raise ValueError(f"bvh_intersect_quads: the tree is {bvh.depth} levels deep, and K8's stack holds "
                         f"{STACK_CAPACITY} entries a ray (depth + 1 needed)")
    return entries


def _uses_kernels(x) -> bool:
    """Whether ``x``'s device runs K8 (a CUDA tensor) rather than the twin
    (a CPU tensor)."""
    return x.is_cuda


def _intersect_cuda(bvh: BVH, quads: QuadSoA, origins, dirs, t_init):
    _check_cuda(bvh, quads, origins, dirs, t_init)
    entries = stack_entries(bvh)
    b = origins.shape[0]
    hit = origins.new_empty((b,), dtype=torch.bool)
    t = origins.new_empty((b,))
    payload = origins.new_empty((b,), dtype=torch.int32)
    if b == 0:  # an empty batch launches nothing
        return hit, t, payload
    table = QuadTable.of(quads)
    lib = _library()
    rc = on_current_stream(lib.bvh_intersect, origins.get_device(), bvh.rows.data_ptr(),
                           bvh.prim_order.data_ptr(), bvh.prim_order.shape[0], ctypes.byref(table),
                           origins.data_ptr(), dirs.data_ptr(), None if t_init is None else t_init.data_ptr(),
                           b, entries, hit.data_ptr(), t.data_ptr(), payload.data_ptr())
    if rc != 0:
        raise RuntimeError(f"bvh_intersect launch failed: {lib.bvh_error_string(rc).decode()}")
    bvh_intersect_quads.launches += 1
    return hit, t, payload


def bvh_intersect_quads(bvh: BVH, quads: QuadSoA, origins, dirs, t_init=None):
    """The nearest world-space quad per lane through ``bvh`` (built over the
    quads' boxes): (hit (B,), t (B,), payload (B,) int32 quad id, -1 on a
    miss); t is ``t_init`` (inf when None) on a miss.  CUDA tensors launch
    kernel K8 and count the launch in ``bvh_intersect_quads.launches`` (a
    tree deeper than its stack raises, :func:`stack_entries`); CPU tensors
    run :func:`bvh_intersect_reference` with :func:`quad_prim_fn`.  Any
    other device raises."""
    if _uses_kernels(origins):
        return _intersect_cuda(bvh, quads, origins, dirs, t_init)
    if origins.device.type == "cpu":
        return bvh_intersect_reference(bvh, origins, dirs, quad_prim_fn(quads), t_init)
    raise ValueError(f"bvh_intersect_quads: unsupported device {origins.device}")


bvh_intersect_quads.launches = 0


def launch_attributes(bvh: BVH, device=None) -> dict:
    """How K8 launches ``bvh`` on the current card (or ``device``):
    {"threads" (per block), "stack_entries" (per thread, in shared memory),
    "capacity" (the most entries a launch can give), "smem_bytes" (per
    block), "registers" (per thread), "stack_frame_bytes" (local memory),
    "resident_blocks_per_sm"}."""
    entries = stack_entries(bvh)
    lib = _library()
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        rc = lib.bvh_intersect_attributes(entries, out)
    if rc != 0:
        raise RuntimeError(f"bvh_intersect attributes failed: {lib.bvh_error_string(rc).decode()}")
    return dict(threads=out[0], stack_entries=entries, capacity=out[1], smem_bytes=entries * 12 * out[0],
                registers=out[2], stack_frame_bytes=out[3], resident_blocks_per_sm=out[4])
