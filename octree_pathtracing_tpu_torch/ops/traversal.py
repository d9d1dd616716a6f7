"""ESVO first-hit traversal in four modes — CUDA kernels (one template
body in ``csrc/traversal.cu``), their plain-torch twins, and the wrappers
that pick between them by device:

- :func:`traverse` — kernel K1, no accept callback;
- :func:`traverse_alpha` — kernel K2, the in-loop alpha accept of
  ``render/hit.make_accept_fn`` (a candidate whose texel alpha is
  <= ``ALPHA_EPSILON`` falls through to ADVANCE; leaves that cannot reject
  are accepted without the texel fetch);
- :func:`traverse_record` — kernel K3r, the recording walk of
  ``diff/soft.record_surfaces``: the first ``K_SURFACES`` surfaces per ray
  are recorded as (mat, face, uu, vv) and the last one is accepted;
- :func:`traverse_shadow` — kernel K3s, the shadow walk of
  ``render/hit.make_shadow_accept_fn``: every alpha surface the ray crosses
  is recorded as (mat, uu, vv[, t]) under a running alpha budget, and the
  walk stops at the ``K_SURFACES``-th surface or when the budget is spent.

Port of ``octree_pathtracing_tpu/ops/traversal.py:traverse`` with those
accept callbacks, for scenes without block models.  Each wrapper launches
its CUDA kernel for CUDA tensors (or raises) and runs its twin for CPU
tensors; there is no fallback from one to the other.

The twins are a direct port of the JAX ``_init`` / ``_step`` / ``_examine``
/ ``_hit_info`` and the accept protocol: component-major ``(3, B)`` masked
tensor updates under a Python loop capped at ``MAX_STEPS`` iterations, two
examinations per fetched node row (the second only for lanes whose first was
a same-parent ADVANCE), then the accept of the lanes whose status became
CANDIDATE in that step.  The kernels run the same decisions one thread per
ray; both round every operation once, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .texture import Atlas, sample_atlas

MAX_STEPS = 1000
MAX_SCALE = 23
EPSILON = 1.1920929e-7  # 2^-23

ACTIVE, CANDIDATE, MISS = 0, 1, 2
ALPHA_EPSILON = 5e-8  # Ray::EPSILON (ops/shading.EPSILON): alpha at or below is a hole
K_SURFACES = 4  # surfaces recorded per ray by traverse_record

VALUE_MASK = 0x3FFFFFFF  # low 30 bits: child index / leaf value
PRESENT_BIT = 30
LEAF_BIT_PACKED = 31

_SIGN = -(1 << 31)  # 0x80000000 as int32
_EPS_BITS = int(np.float32(EPSILON).view(np.int32))


class HitResult(NamedTuple):
    hit: torch.Tensor  # (B,) bool
    t: torch.Tensor  # (B,) world-space t (inf on miss)
    face_id: torch.Tensor  # (B,) int32 (axis*2 | negative-dir bit), -1 on miss
    uv: torch.Tensor  # (B, 2)
    leaf_value: torch.Tensor  # (B,) int32 (values fit 30 bits), 0 on miss
    voxel_pos: torch.Tensor  # (B, 3) world-space voxel min corner
    voxel_size: torch.Tensor  # (B,) world-space voxel side
    steps: torch.Tensor  # () int32 — max node fetches over the lanes
    fetches: torch.Tensor  # (B,) int32 — node fetches per lane


class AlphaTables(NamedTuple):
    """What the alpha accept reads (``render/hit.accept_tables`` builds it)."""

    leaf_material: torch.Tensor  # (L,) int32: leaf value -> material
    texture_index: torch.Tensor  # (M,) int32: material -> atlas layer
    atlas: torch.Tensor  # (T, H, W, 4) float32 texels
    sizes: torch.Tensor | None  # (T, 2) int32 per-layer (h, w), or None
    rejectable: torch.Tensor  # (L,) bool: some texel of the leaf is a hole
    binary: torch.Tensor  # (L,) bool: every texel alpha is 1 (shadow walk)
    ior: torch.Tensor  # (M,) float32 material IOR (shadow walk, strict)


class SurfaceRecord(NamedTuple):
    """The surfaces :func:`traverse_record` crossed, front to back."""

    count: torch.Tensor  # (B,) int32 surfaces recorded (<= K_SURFACES)
    mats: torch.Tensor  # (K, B) int32 material of each
    face: torch.Tensor  # (K, B) int32 entry face of each
    uu: torch.Tensor  # (K, B) float32
    vv: torch.Tensor  # (K, B) float32


class ShadowState(NamedTuple):
    """What :func:`traverse_shadow` recorded (``render/hit.shadow_state_init``
    without the drained walk's ``t_last``)."""

    count: torch.Tensor  # (B,) int32 surfaces recorded (<= K_SURFACES)
    w: torch.Tensor  # (B,) float32 alpha budget left
    cm: torch.Tensor  # (B,) int32 medium after the last surface (cur_mat before any)
    mats: torch.Tensor  # (K, B) int32
    uu: torch.Tensor  # (K, B) float32
    vv: torch.Tensor  # (K, B) float32
    ts: torch.Tensor | None  # (K, B) float32 world t (inf when unused), or None


def pack_nodes(child_mask, child_data):
    """(N,) mask + (N, 8) children -> (N, 8) int32 flags-in-word table.

    Per child word: value (30 bits) | present << 30 | leaf << 31."""
    slots = torch.arange(8, dtype=torch.int64, device=child_mask.device)
    m = child_mask.to(torch.int64)[:, None]
    present = (m >> slots) & 1
    leaf = (m >> (slots + 8)) & 1
    packed = (child_data.to(torch.int64) & VALUE_MASK) | (present << PRESENT_BIT) | (leaf << LEAF_BIT_PACKED)
    packed = torch.where(packed >= 1 << 31, packed - (1 << 32), packed)  # as int32 bits
    return packed.to(torch.int32).contiguous()


def _bits(x):
    return x.view(torch.int32)


def _fbits(x):
    return x.view(torch.float32)


def _octant(b):
    """(3, B) bool -> (B,) int32 bitmask x | y << 1 | z << 2."""
    b = b.to(torch.int32)
    return b[0] | (b[1] << 1) | (b[2] << 2)


def _init(root, octree_scale, origins, dirs, stack_rows):
    """Per-lane setup: rays into the [1, 2) cube, sign-preserving epsilon
    clamp, mirroring to negative directions, root entry."""
    f32 = torch.float32
    ro = origins.to(f32).T * octree_scale + 1.0  # (3, B)
    rd = dirs.to(f32).T.contiguous()
    b = ro.shape[1]
    dev = ro.device

    small = torch.abs(rd) < EPSILON
    rd = torch.where(small, _fbits(_EPS_BITS | (_bits(rd) & _SIGN)), rd)

    t_coef = 1.0 / -torch.abs(rd)
    t_bias = t_coef * ro
    pos_dir = rd > 0.0
    mirror = _octant(pos_dir)
    t_bias = torch.where(pos_dir, 3.0 * t_coef - t_bias, t_bias)

    t_min = torch.clamp(torch.amax(2.0 * t_coef - t_bias, dim=0), min=0.0)
    t_max = torch.amin(t_coef - t_bias, dim=0)
    upper_gt = (1.5 * t_coef - t_bias) > t_min[None, :]
    consts = dict(ro=ro, rd=rd, t_coef=t_coef, t_bias=t_bias, mirror=mirror)
    zi = torch.zeros((b,), dtype=torch.int32, device=dev)
    state = dict(
        pos=torch.where(upper_gt, 1.5, 1.0).to(f32),
        index=_octant(upper_gt),
        parent=zi + int(root),
        scale=zi + (MAX_SCALE - 1),
        scale_exp2=torch.full((b,), 0.5, dtype=f32, device=dev),
        t_min=t_min,
        t_max=t_max,
        h=t_max.clone(),
        stack_idx=torch.zeros((stack_rows, b), dtype=torch.int32, device=dev),
        stack_t=torch.zeros((stack_rows, b), dtype=f32, device=dev),
        status=zi.clone(),
        cand=zi.clone(),
        reject=torch.zeros((b,), dtype=torch.bool, device=dev),
    )
    return consts, state


def _examine(row, c, s, scale_base, max_dst, act_mask):
    """One masked PUSH / ADVANCE / POP / hit decision against a fetched node
    row.  Returns (new state, lanes whose next examination may reuse the row)."""
    active = s["status"] == ACTIVE
    if act_mask is not None:
        active = active & act_mask
    pos, t_min, t_max = s["pos"], s["t_min"], s["t_max"]
    se = s["scale_exp2"]

    dist_miss = active & (t_min > max_dst)
    t_corner = pos * c["t_coef"] - c["t_bias"]  # (3, B)
    tc_max = torch.amin(t_corner, dim=0)

    slot = s["index"] ^ c["mirror"]
    word = torch.gather(row, 1, slot[:, None].long())[:, 0]
    value = word & VALUE_MASK
    present = ((word >> PRESENT_BIT) & 1) != 0
    leafb = word < 0  # bit 31
    valid = present & (t_min <= t_max)
    live = active & ~dist_miss
    # a lane whose candidate the accept rejected must ADVANCE past it
    rejected = s["reject"]
    is_hit = live & valid & leafb & (t_min > 0.0) & ~rejected

    half = se * 0.5
    t_center = half[None, :] * c["t_coef"] + t_corner
    tv_max = torch.minimum(t_max, tc_max)
    do_push = live & valid & ~leafb & (t_min <= tv_max) & ~rejected
    do_adv = live & ~is_hit & ~do_push

    # ---- PUSH ----
    rows = torch.arange(s["stack_idx"].shape[0], dtype=torch.int32, device=row.device)[:, None]
    sel = (do_push & (tc_max < s["h"]))[None, :] & (rows == (s["scale"] - scale_base)[None, :])
    stack_idx = torch.where(sel, s["parent"][None, :], s["stack_idx"])
    stack_t = torch.where(sel, t_max[None, :], s["stack_t"])
    push_bits = t_center > t_min[None, :]
    push_index = _octant(push_bits)
    push_pos = pos + torch.where(push_bits, half[None, :], 0.0)

    # ---- ADVANCE ----
    adv_bits = t_corner <= tc_max[None, :]
    step_mask = _octant(adv_bits)
    adv_pos = pos - torch.where(adv_bits, se[None, :], 0.0)
    adv_index = s["index"] ^ step_mask
    pop_needed = do_adv & ((adv_index & step_mask) != 0)

    # ---- POP: the highest differing bit of the advanced coordinates ----
    diff_axis = _bits(adv_pos) ^ _bits(adv_pos + se[None, :])
    differing = torch.where(adv_bits, diff_axis, 0)
    differing = differing[0] | differing[1] | differing[2]
    # 31 - clz(x) == frexp exponent - 1 for x >= 1 (exact in float64)
    p_scale = torch.frexp(torch.clamp(differing, min=1).to(torch.float64)).exponent - 1
    pop_miss = pop_needed & (p_scale >= MAX_SCALE)
    p_scale_c = torch.clamp(p_scale, scale_base, MAX_SCALE - 1).to(torch.int32)
    p_rel = (p_scale_c - scale_base).long()[None, :]
    p_scale_exp2 = _fbits((p_scale_c - MAX_SCALE + 127) << 23)
    p_parent = torch.gather(stack_idx, 0, p_rel)[0]
    p_t_max = torch.gather(stack_t, 0, p_rel)[0]
    sh = _bits(adv_pos) >> p_scale_c[None, :]
    p_pos = _fbits(sh << p_scale_c[None, :])
    p_index = _octant((sh & 1) != 0)
    do_pop = pop_needed & ~pop_miss

    # ---- merge lane updates ----
    new_pos = torch.where(do_push[None, :], push_pos, pos)
    new_pos = torch.where(do_adv[None, :], adv_pos, new_pos)
    new_pos = torch.where(do_pop[None, :], p_pos, new_pos)
    index = torch.where(do_push, push_index, s["index"])
    index = torch.where(do_adv, adv_index, index)
    index = torch.where(do_pop, p_index, index)
    parent = torch.where(do_push, value, s["parent"])
    parent = torch.where(do_pop, p_parent, parent)
    scale = torch.where(do_push, s["scale"] - 1, s["scale"])
    scale = torch.where(do_pop, p_scale_c, scale)
    scale_exp2 = torch.where(do_push, half, se)
    scale_exp2 = torch.where(do_pop, p_scale_exp2, scale_exp2)
    new_t_min = torch.where(do_adv, tc_max, t_min)
    new_t_max = torch.where(do_push, tv_max, t_max)
    new_t_max = torch.where(do_pop, p_t_max, new_t_max)
    h = torch.where(do_push, tc_max, s["h"])
    h = torch.where(do_pop, 0.0, h)
    status = torch.where(is_hit, CANDIDATE, s["status"])
    status = torch.where(dist_miss | pop_miss, MISS, status).to(torch.int32)
    cand = torch.where(is_hit, value, s["cand"])

    same_parent = do_adv & ~do_pop & (status == ACTIVE)
    return dict(
        pos=new_pos,
        index=index,
        parent=parent,
        scale=scale,
        scale_exp2=scale_exp2,
        t_min=new_t_min,
        t_max=new_t_max,
        h=h,
        stack_idx=stack_idx,
        stack_t=stack_t,
        status=status,
        cand=cand,
        reject=torch.where(active, False, rejected),
    ), same_parent


def _hit_info(c, s):
    """Face id + uv + unmirrored voxel corner of the final lane state."""
    se = s["scale_exp2"]
    pos = s["pos"]
    mbit = torch.stack([((c["mirror"] >> i) & 1) != 0 for i in range(3)])  # (3, B)
    unmirrored_pos = torch.where(mbit, 3.0 - se[None, :] - pos, pos)
    t_corner_h = (pos + se[None, :]) * c["t_coef"] - c["t_bias"]
    tc_min = torch.amax(t_corner_h, dim=0)
    eq = t_corner_h == tc_min[None, :]
    axis = torch.where(eq[0], 0, torch.where(eq[1], 1, 2)).to(torch.int32)  # first axis wins
    rd = c["rd"]
    rd_ax = torch.gather(rd, 0, axis.long()[None, :])[0]
    sign = (_bits(rd_ax) < 0).to(torch.int32)
    face = axis * 2 + sign

    def pick(arr, ax_idx):
        return torch.gather(arr, 0, ax_idx.long()[None, :])[0]

    a1 = torch.where(axis == 0, 2, 0)
    a2 = torch.where(axis == 1, 2, 1)
    ro = c["ro"]
    uu = (pick(ro, a1) + pick(rd, a1) * tc_min - pick(unmirrored_pos, a1)) / se
    vv = (pick(ro, a2) + pick(rd, a2) * tc_min - pick(unmirrored_pos, a2)) / se
    neg = rd_ax < 0.0
    uu = torch.where(neg & (axis != 1), 1.0 - uu, uu)
    vv = torch.where(neg & (axis == 1), 1.0 - vv, vv)
    return face, uu, vv, unmirrored_pos


def _check_depth(depth: int):
    if not 1 <= int(depth) <= MAX_SCALE:
        raise ValueError(f"octree depth {depth} outside 1..{MAX_SCALE}")


def _alpha_accept(c, s, tables: AlphaTables, mode: int, fresh, rec):
    """The accept of the twins, on every lane (only ``fresh`` lanes count):
    mode 1 passes non-rejectable leaves and texels above ALPHA_EPSILON;
    mode 2 records each surface into ``rec`` and passes the K-th.  Table
    indices clip as the kernel's (and XLA's gathers) do.
    Returns (ok (B,) bool, rec)."""
    face, uu, vv, _ = _hit_info(c, s)
    n_leaf = tables.leaf_material.shape[0]
    lv = torch.clamp(s["cand"], 0, n_leaf - 1).long()
    mat = torch.clamp(tables.leaf_material[lv], 0, tables.texture_index.shape[0] - 1)
    layer = torch.clamp(tables.texture_index[mat.long()], 0, tables.atlas.shape[0] - 1)
    atlas = tables.atlas if tables.sizes is None else Atlas(tables.atlas, tables.sizes)
    is_surface = sample_atlas(atlas, layer, uu, vv)[:, 3] > ALPHA_EPSILON
    if mode == 1:
        return is_surface | ~tables.rejectable[lv], rec
    is_surface = fresh & is_surface
    rows = torch.arange(K_SURFACES, dtype=torch.int32, device=lv.device)[:, None]
    sel = is_surface[None, :] & (rows == rec.count[None, :])
    count = rec.count + is_surface.to(torch.int32)
    rec = SurfaceRecord(
        count=count,
        mats=torch.where(sel, mat[None, :], rec.mats),
        face=torch.where(sel, face[None, :], rec.face),
        uu=torch.where(sel, uu[None, :], rec.uu),
        vv=torch.where(sel, vv[None, :], rec.vv),
    )
    return is_surface & (count >= K_SURFACES), rec


def _shadow_accept(c, s, tables: AlphaTables, fresh, st: ShadowState, strict: bool, inv_scale):
    """The shadow walk's accept (``make_shadow_accept_fn``), on every lane
    (only ``fresh`` lanes count).  A binary-class leaf is a surface of alpha
    exactly 1 with the entry face's uv; any other leaf is a surface when its
    texel alpha is above ALPHA_EPSILON.  Returns (stop (B,) bool, state)."""
    _, uu, vv, _ = _hit_info(c, s)
    n_leaf, n_mat = tables.leaf_material.shape[0], tables.texture_index.shape[0]
    lv = torch.clamp(s["cand"], 0, n_leaf - 1).long()
    mat = torch.clamp(tables.leaf_material[lv], 0, n_mat - 1)
    layer = torch.clamp(tables.texture_index[mat.long()], 0, tables.atlas.shape[0] - 1)
    atlas = tables.atlas if tables.sizes is None else Atlas(tables.atlas, tables.sizes)
    texel = sample_atlas(atlas, layer, uu, vv)[:, 3]
    is_bin = tables.binary[lv]
    alpha = torch.where(is_bin, 1.0, texel)
    is_surface = fresh & (is_bin | (texel > ALPHA_EPSILON))
    new_w = st.w * (1.0 - alpha)
    if strict:
        ior_change = tables.ior[torch.clamp(st.cm, 0, n_mat - 1).long()] != tables.ior[mat.long()]
        new_w = torch.where(ior_change, 0.0, new_w)
    rows = torch.arange(K_SURFACES, dtype=torch.int32, device=lv.device)[:, None]
    sel = is_surface[None, :] & (rows == st.count[None, :])
    count = st.count + is_surface.to(torch.int32)
    w = torch.where(is_surface, new_w, st.w)
    ts = st.ts
    if ts is not None:
        ts = torch.where(sel, (s["t_min"] * inv_scale)[None, :], ts)
    st = ShadowState(
        count=count,
        w=w,
        cm=torch.where(is_surface, mat, st.cm),
        mats=torch.where(sel, mat[None, :], st.mats),
        uu=torch.where(sel, uu[None, :], st.uu),
        vv=torch.where(sel, vv[None, :], st.vv),
        ts=ts,
    )
    return is_surface & ((count >= K_SURFACES) | (w <= 0.0)), st


def _walk_reference(mode, nodes_packed, root, depth, octree_scale, origins, dirs, max_dst,
                    active, tables, shadow=None):
    """The twins' walk: mode 0 (K1), 1 (K2), 2 (K3r) or 3 (K3s, with
    ``shadow = (cur_mat, strict, record_t)``).
    Returns (HitResult, SurfaceRecord / ShadowState or None)."""
    _check_depth(depth)
    scale_base = MAX_SCALE - int(depth)
    c, s = _init(root, octree_scale, origins, dirs, int(depth) + 1)
    if active is not None:
        s["status"] = torch.where(active, s["status"], MISS).to(torch.int32)
    max_dst_c = float(np.float32(max_dst * octree_scale))
    inv_scale = 1.0 / octree_scale
    steps = torch.zeros_like(s["status"])
    rec = None
    zi = torch.zeros((K_SURFACES, steps.shape[0]), dtype=torch.int32, device=steps.device)
    if mode == 2:
        rec = SurfaceRecord(steps.clone(), zi, zi.clone(), zi.float(), zi.float())
    elif mode == 3:
        cur_mat, strict, record_t = shadow
        rec = ShadowState(
            count=steps.clone(),
            w=torch.ones_like(steps, dtype=torch.float32),
            cm=cur_mat.to(torch.int32),
            mats=zi,
            uu=zi.float(),
            vv=zi.float(),
            ts=torch.full_like(zi, float("inf"), dtype=torch.float32) if record_t else None,
        )
    for _ in range(MAX_STEPS):
        live = s["status"] == ACTIVE
        if not bool(live.any()):
            break
        row = nodes_packed[s["parent"].long()]  # (B, 8): the step's one fetch
        s, same_parent = _examine(row, c, s, scale_base, max_dst_c, None)
        s, _ = _examine(row, c, s, scale_base, max_dst_c, same_parent)
        if mode:
            fresh = live & (s["status"] == CANDIDATE)
            if bool(fresh.any()):
                if mode == 3:
                    ok, rec = _shadow_accept(c, s, tables, fresh, rec, shadow[1], inv_scale)
                else:
                    ok, rec = _alpha_accept(c, s, tables, mode, fresh, rec)
                rej = fresh & ~ok
                s["status"] = torch.where(rej, ACTIVE, s["status"]).to(torch.int32)
                s["reject"] = s["reject"] | rej
        steps += live.to(torch.int32)

    hit = s["status"] == CANDIDATE
    face, uu, vv, unmirrored_pos = _hit_info(c, s)
    res = HitResult(
        hit=hit,
        t=torch.where(hit, s["t_min"] * inv_scale, float("inf")),
        face_id=torch.where(hit, face, -1).to(torch.int32),
        uv=torch.stack([uu, vv], dim=-1),
        leaf_value=torch.where(hit, s["cand"], 0).to(torch.int32),
        voxel_pos=((unmirrored_pos - 1.0) * inv_scale).T.contiguous(),
        voxel_size=s["scale_exp2"] * inv_scale,
        steps=steps.max() if steps.numel() else torch.zeros((), dtype=torch.int32),
        fetches=steps,
    )
    return res, rec


def traverse_reference(nodes_packed, root, depth, octree_scale, origins, dirs, max_dst=1024.0,
                       active=None):
    """Plain-torch twin of kernel K1 (any device).  Same signature and
    result as :func:`traverse`."""
    return _walk_reference(0, nodes_packed, root, depth, octree_scale, origins, dirs, max_dst,
                           active, None)[0]


def traverse_alpha_reference(nodes_packed, root, depth, octree_scale, origins, dirs,
                             tables: AlphaTables, max_dst=1024.0, active=None):
    """Plain-torch twin of kernel K2 (any device).  Same signature and
    result as :func:`traverse_alpha`."""
    return _walk_reference(1, nodes_packed, root, depth, octree_scale, origins, dirs, max_dst,
                           active, tables)[0]


def traverse_record_reference(nodes_packed, root, depth, octree_scale, origins, dirs,
                              tables: AlphaTables, max_dst=1024.0):
    """Plain-torch twin of kernel K3r (any device).  Same signature and
    result as :func:`traverse_record`."""
    return _walk_reference(2, nodes_packed, root, depth, octree_scale, origins, dirs, max_dst,
                           None, tables)


def traverse_shadow_reference(nodes_packed, root, depth, octree_scale, origins, dirs,
                              tables: AlphaTables, cur_mat, strict: bool, record_t: bool,
                              max_dst=1024.0, active=None):
    """Plain-torch twin of kernel K3s (any device).  Same signature and
    result as :func:`traverse_shadow`."""
    return _walk_reference(3, nodes_packed, root, depth, octree_scale, origins, dirs, max_dst,
                           active, tables, (cur_mat, bool(strict), bool(record_t)))


@functools.cache
def _library():
    """The traversal kernels' shared library (K1, K2, K3r, K3s), built at first use."""
    from ..utils.cuda_build import load_library

    # IEEE rounding of every operation, no FMA contraction: the twin and the
    # JAX reference round each multiply and add separately (see the source note)
    lib = load_library("traversal", ("-fmad=false",))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [vp, ci, ci, cf, cf, cf, vp, vp, vp, ci]  # nodes .. n
    tables = [vp, ci, vp, ci, vp, ci, ci, ci, vp]  # leaf_material .. sizes
    lib.esvo_traverse.argtypes = head + [vp] * 8 + [vp]
    lib.esvo_traverse_alpha.argtypes = head + tables + [vp] + [vp] * 8 + [vp]
    lib.esvo_traverse_record.argtypes = head + tables + [vp] * 8 + [vp] * 5 + [vp]
    lib.esvo_traverse_shadow.argtypes = head + tables + [vp, vp, vp, ci] + [vp] * 8 + [vp] * 7 + [vp]
    for fn in (lib.esvo_traverse, lib.esvo_traverse_alpha, lib.esvo_traverse_record,
               lib.esvo_traverse_shadow):
        fn.restype = ci
    lib.esvo_error_string.argtypes = [ci]
    lib.esvo_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(nodes, origins, dirs, active, tables, mode, cur_mat):
    dev = origins.device
    b = origins.shape[0]
    checks = [
        (nodes.dtype == torch.int32 and nodes.dim() == 2 and nodes.shape[1] == 8, "nodes must be (N, 8) int32"),
        (origins.dtype == torch.float32 and origins.shape == (b, 3), "origins must be (B, 3) float32"),
        (dirs.dtype == torch.float32 and dirs.shape == (b, 3), "dirs must be (B, 3) float32"),
        (all(x.is_contiguous() for x in (nodes, origins, dirs)), "inputs must be contiguous"),
        (nodes.device == dev and dirs.device == dev, "all inputs must be on one device"),
        (nodes.data_ptr() % 16 == 0, "node table must be 16-byte aligned"),
        (b < 2**31, "too many rays for one launch"),
    ]
    if active is not None:
        checks.append(
            (active.dtype == torch.bool and active.shape == (b,) and active.is_contiguous()
             and active.device == dev, "active must be a contiguous (B,) bool on the rays' device")
        )
    if tables is not None:
        lm, ti, atlas, sizes, rej = tables.leaf_material, tables.texture_index, tables.atlas, tables.sizes, tables.rejectable
        n_layer = atlas.shape[0] if atlas.dim() == 4 else 0
        checks += [
            (lm.dtype == torch.int32 and lm.dim() == 1 and lm.shape[0] > 0, "leaf_material must be (L,) int32"),
            (ti.dtype == torch.int32 and ti.dim() == 1 and ti.shape[0] > 0, "texture_index must be (M,) int32"),
            (atlas.dtype == torch.float32 and atlas.dim() == 4 and atlas.shape[3] == 4 and n_layer > 0,
             "atlas must be (T, H, W, 4) float32"),
            (sizes is None or (sizes.dtype == torch.int32 and sizes.shape == (n_layer, 2)),
             "sizes must be None or (T, 2) int32"),
            (rej.dtype == torch.bool and rej.shape == lm.shape, "rejectable must be (L,) bool"),
            (all(x.is_contiguous() and x.device == dev for x in (lm, ti, atlas, rej))
             and (sizes is None or (sizes.is_contiguous() and sizes.device == dev)),
             "tables must be contiguous and on the rays' device"),
        ]
    if mode == 3:
        bi, ior = tables.binary, tables.ior
        checks += [
            (bi.dtype == torch.bool and bi.shape == lm.shape and bi.is_contiguous()
             and bi.device == dev, "binary must be a contiguous (L,) bool on the rays' device"),
            (ior.dtype == torch.float32 and ior.shape == ti.shape
             and ior.is_contiguous() and ior.device == dev,
             "ior must be a contiguous (M,) float32 on the rays' device"),
            (cur_mat.dtype == torch.int32 and cur_mat.shape == (b,) and cur_mat.is_contiguous()
             and cur_mat.device == dev, "cur_mat must be a contiguous (B,) int32 on the rays' device"),
        ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"traverse: {msg}")


def _traverse_cuda(wrapper, mode, nodes, root, depth, octree_scale, origins, dirs, max_dst, active, tables,
                   shadow=None):
    cur_mat, strict, record_t = shadow if mode == 3 else (None, False, False)
    _check_cuda_inputs(nodes, origins, dirs, active, tables, mode, cur_mat)
    b = origins.shape[0]
    dev = origins.device
    f32, i32 = torch.float32, torch.int32
    out = HitResult(
        hit=torch.empty((b,), dtype=torch.bool, device=dev),
        t=torch.empty((b,), dtype=f32, device=dev),
        face_id=torch.empty((b,), dtype=i32, device=dev),
        uv=torch.empty((b, 2), dtype=f32, device=dev),
        leaf_value=torch.empty((b,), dtype=i32, device=dev),
        voxel_pos=torch.empty((b, 3), dtype=f32, device=dev),
        voxel_size=torch.empty((b,), dtype=f32, device=dev),
        steps=torch.zeros((), dtype=i32, device=dev),
        fetches=torch.empty((b,), dtype=i32, device=dev),
    )
    rec = None
    if mode == 2:
        rec = SurfaceRecord(
            count=torch.empty((b,), dtype=i32, device=dev),
            mats=torch.empty((K_SURFACES, b), dtype=i32, device=dev),
            face=torch.empty((K_SURFACES, b), dtype=i32, device=dev),
            uu=torch.empty((K_SURFACES, b), dtype=f32, device=dev),
            vv=torch.empty((K_SURFACES, b), dtype=f32, device=dev),
        )
    elif mode == 3:
        rec = ShadowState(
            count=torch.empty((b,), dtype=i32, device=dev),
            w=torch.empty((b,), dtype=f32, device=dev),
            cm=torch.empty((b,), dtype=i32, device=dev),
            mats=torch.empty((K_SURFACES, b), dtype=i32, device=dev),
            uu=torch.empty((K_SURFACES, b), dtype=f32, device=dev),
            vv=torch.empty((K_SURFACES, b), dtype=f32, device=dev),
            ts=torch.empty((K_SURFACES, b), dtype=f32, device=dev) if record_t else None,
        )
    if b == 0:  # an empty batch launches nothing
        return out, rec
    lib = _library()
    head = (nodes.data_ptr(), int(root), int(depth), float(octree_scale),
            float(1.0 / octree_scale), float(np.float32(max_dst * octree_scale)),
            origins.data_ptr(), dirs.data_ptr(), None if active is None else active.data_ptr(), b)
    outs = tuple(x.data_ptr() for x in out[:7]) + (out.fetches.data_ptr(),)
    if tables is not None:
        lm, ti, atlas, sizes = tables.leaf_material, tables.texture_index, tables.atlas, tables.sizes
        tabs = (lm.data_ptr(), lm.shape[0], ti.data_ptr(), ti.shape[0], atlas.data_ptr(),
                atlas.shape[0], atlas.shape[1], atlas.shape[2],
                None if sizes is None else sizes.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mode == 0:
            rc = lib.esvo_traverse(*head, *outs, stream)
        elif mode == 1:
            rc = lib.esvo_traverse_alpha(*head, *tabs, tables.rejectable.data_ptr(), *outs, stream)
        elif mode == 2:
            rc = lib.esvo_traverse_record(*head, *tabs, *outs, *(x.data_ptr() for x in rec), stream)
        else:
            rc = lib.esvo_traverse_shadow(
                *head, *tabs, tables.binary.data_ptr(), tables.ior.data_ptr(), cur_mat.data_ptr(),
                int(strict), *outs, rec.count.data_ptr(), rec.mats.data_ptr(), rec.uu.data_ptr(),
                rec.vv.data_ptr(), rec.w.data_ptr(), rec.cm.data_ptr(),
                None if rec.ts is None else rec.ts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"esvo traversal (mode {mode}) launch failed: {lib.esvo_error_string(rc).decode()}")
    wrapper.launches += 1
    return out._replace(steps=out.fetches.max()), rec


def _dispatch(wrapper, mode, *args):
    """The kernel of ``mode`` for CUDA rays, its twin for CPU rays.
    Returns (HitResult, SurfaceRecord / ShadowState or None)."""
    nodes, root, depth, octree_scale, origins = args[:5]
    _check_depth(depth)
    if origins.device.type == "cuda":
        return _traverse_cuda(wrapper, mode, *args)
    if origins.device.type == "cpu":
        return _walk_reference(mode, *args)
    raise ValueError(f"traverse: unsupported device {origins.device}")


def traverse(nodes_packed, root, depth, octree_scale, origins, dirs, max_dst=1024.0, active=None):
    """Trace a ray batch to its first leaf hits.

    ``nodes_packed``: (N, 8) int32 table of :func:`pack_nodes`; ``depth``
    sizes the per-lane stack; ``origins``/``dirs``: (B, 3) float32 world
    space; ``max_dst``: world-space distance cap; ``active``: optional (B,)
    bool — False lanes start as MISS and fetch nothing.

    CUDA tensors launch kernel K1 (``csrc/traversal.cu``, mode 0) and count
    the launch in ``traverse.launches``; CPU tensors run
    :func:`traverse_reference`.  Any other device raises."""
    return _dispatch(traverse, 0, nodes_packed, root, depth, octree_scale, origins, dirs, max_dst,
                     active, None)[0]


def traverse_alpha(nodes_packed, root, depth, octree_scale, origins, dirs, tables: AlphaTables,
                   max_dst=1024.0, active=None):
    """:func:`traverse` with the in-loop alpha accept: a leaf candidate whose
    leaf is ``tables.rejectable`` and whose texel alpha at the hit uv is
    <= ``ALPHA_EPSILON`` is rejected, and the ray walks on past it.

    CUDA tensors launch kernel K2 (mode 1) and count the launch in
    ``traverse_alpha.launches``; CPU tensors run
    :func:`traverse_alpha_reference`."""
    return _dispatch(traverse_alpha, 1, nodes_packed, root, depth, octree_scale, origins, dirs,
                     max_dst, active, tables)[0]


def traverse_record(nodes_packed, root, depth, octree_scale, origins, dirs, tables: AlphaTables,
                    max_dst=1024.0):
    """Walk each ray through its first ``K_SURFACES`` surfaces (candidates
    whose texel alpha is above ``ALPHA_EPSILON``), recording each, and
    accept the last.  Returns (HitResult, SurfaceRecord); ``rejectable`` is
    not read.

    CUDA tensors launch kernel K3r (mode 2) and count the launch in
    ``traverse_record.launches``; CPU tensors run
    :func:`traverse_record_reference`."""
    return _dispatch(traverse_record, 2, nodes_packed, root, depth, octree_scale, origins, dirs,
                     max_dst, None, tables)


def traverse_shadow(nodes_packed, root, depth, octree_scale, origins, dirs, tables: AlphaTables,
                    cur_mat, strict: bool, record_t: bool, max_dst=1024.0, active=None):
    """The shadow walk: record each alpha surface the ray crosses, front to
    back, with a running alpha budget ``w *= 1 - alpha`` that starts at 1;
    stop at the ``K_SURFACES``-th surface or when ``w <= 0``.  A leaf of the
    ``tables.binary`` class is a surface of alpha 1 read without a texel
    fetch.  ``strict`` zeroes the budget when a surface's IOR differs from
    the medium's (``cur_mat`` (B,) int32 before the first surface);
    ``record_t`` records each surface's world t as well.  ``active``: False
    lanes start as MISS and fetch nothing.  Returns (HitResult, ShadowState).

    CUDA tensors launch kernel K3s (mode 3) and count the launch in
    ``traverse_shadow.launches``; CPU tensors run
    :func:`traverse_shadow_reference`."""
    return _dispatch(traverse_shadow, 3, nodes_packed, root, depth, octree_scale, origins, dirs,
                     max_dst, active, tables, (cur_mat, bool(strict), bool(record_t)))


traverse.launches = 0
traverse_alpha.launches = 0
traverse_record.launches = 0
traverse_shadow.launches = 0
