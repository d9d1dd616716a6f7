"""Kernel K5, the compaction of live lanes between bounces: a stable
partition of the lane state with the live lanes first, its backward, and
the final scatter of the radiance back to the lanes' own order (port of
``render/pathtracer.py`` ``_sort_state_by_active`` with ``key="active"``,
the gather of each bounce's uniforms through the carried lane index, and
the final ``.at[idx].set``).

Lane ``i`` goes to row ``pos[i]``: the live lanes before it if it is live,
the live count plus the dead lanes before it if it is dead (JAX's cumsum
formula).  Every state field moves with it, and so does ``idx``, the lane's
original index (the identity before the first compaction); the bounce's
uniform rows are read through ``idx``.  Every shape stays the batch's, so
no call reads the card from the host: the live count goes to slot
``bounce`` of a device ``counts`` tensor.  Only the throughput and the
radiance carry gradient; the backward moves each cotangent row back
through ``pos``.

The bounce loop calls :func:`compact_for_bounce`, which folds that
backward into the stores of the next bounce's backwards: the compaction
makes no autograd node, the kernel also writes ``src``, the inverse of
``pos`` (row ``j`` came from lane ``src[j]``), and K4
(``ops/shade.shade``) and the next-event half (``ops/nee.nee``) take the
throughput and the radiance from before the compaction as their
differentiable inputs (:class:`Lanes`): K4's backward and ``nee_backward``
store each row's gradients at row ``src[j]``, on the card in their kernels
and on the CPU through :func:`store_at_src_reference`.  So no frame
launches ``compact_backward``; :func:`compact` keeps it for a direct
caller.

:func:`compact` and :func:`unpermute` launch the kernels of
``csrc/compact.cu`` on CUDA tensors and run the plain versions
(:func:`compact_reference`, :func:`unpermute_reference` and their
backwards) on CPU tensors; any other device raises.  There is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.cuda_build import on_current_stream
from .shading import N_UNIFORMS

# the lane state a bounce reads and writes, and the carried original index
STATE_KEYS = ("origin", "dir", "throughput", "radiance", "active", "specular", "cur_mat")
FLOAT_KEYS = STATE_KEYS[:4]
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
_DTYPES = dict.fromkeys(FLOAT_KEYS, _F32) | {"active": _BOOL, "specular": _BOOL, "cur_mat": _I32, "idx": _I32}


# ---- the plain versions

def compact_reference(st: dict, uniforms, bounce: int, counts=None, with_src: bool = False):
    """Plain version of ``compact_forward`` (any device): ``st`` holds
    ``STATE_KEYS`` and ``idx`` ((B,) int32, or None for the identity);
    ``uniforms`` is the frame's (B, n_bounces, N_UNIFORMS) block.  Returns
    (the new state with ``idx``, the bounce's (B, N_UNIFORMS) uniforms,
    ``pos`` (B,) int32), and ``src`` (B,) int32 last where ``with_src``;
    writes the live count to ``counts[bounce]`` where ``counts`` is
    given."""
    active = st["active"]
    b = active.shape[0]
    # JAX's destination of each lane: the live lanes first in their order, then the dead ones
    a = active.to(torch.int64)
    n_act = torch.cumsum(a, 0)
    total = n_act[-1] if b else a.sum()
    pos = torch.where(active, n_act - 1, total + torch.cumsum(1 - a, 0) - 1).to(torch.int32)
    perm = torch.empty((b,), dtype=torch.int64, device=pos.device)
    perm[pos.long()] = torch.arange(b, device=pos.device)
    idx = st.get("idx")
    idx = torch.arange(b, dtype=_I32, device=pos.device) if idx is None else idx
    out = {k: st[k][perm] for k in STATE_KEYS}
    out["idx"] = idx[perm]
    if counts is not None:
        counts[bounce] = total
    u = uniforms[out["idx"].long(), bounce]
    return (out, u, pos, perm.to(torch.int32)) if with_src else (out, u, pos)


def compact_backward_reference(pos, g_throughput, g_radiance):
    """Plain version of ``compact_backward`` (any device): the cotangents of
    the compacted throughput and radiance moved back to the lanes' rows,
    ``d[i] = g[pos[i]]`` (None stays None)."""
    p = pos.long()
    return tuple(None if g is None else g[p] for g in (g_throughput, g_radiance))


def store_at_src_reference(src, *grads):
    """Plain version of the stores through ``src`` that K4's backward and
    ``nee_backward`` make after a :func:`compact_for_bounce` compaction:
    each row's gradient back at the lane it came from, ``d[src[j]] = g[j]``
    (None stays None); the same rows as :func:`compact_backward_reference`
    gathers through ``pos``."""
    s = src.long()
    return tuple(None if g is None else torch.empty_like(g).index_copy_(0, s, g) for g in grads)


def unpermute_reference(radiance, idx):
    """Plain version of ``unpermute``'s forward (any device):
    ``zeros.at[idx].set(radiance)``, each lane's row back at its own index."""
    return torch.zeros_like(radiance).index_put_((idx.long(),), radiance)


def unpermute_backward_reference(g, idx):
    """Plain version of ``unpermute``'s backward: ``d[j] = g[idx[j]]``."""
    return g[idx.long()]


class Lanes(NamedTuple):
    """What a bounce after a :func:`compact_for_bounce` compaction
    differentiates: the throughput and the radiance as they were before it
    (the gradient's inputs; the compacted rows are the data the kernels
    read), and ``src``: row ``j`` came from lane ``src[j]``."""

    throughput: torch.Tensor
    radiance: torch.Tensor
    src: torch.Tensor


# ---- the autograd functions and the wrappers

class CompactFunction(torch.autograd.Function):
    """K5 as an autograd function of (throughput, radiance), the rest of the
    call in ``call`` = (state, uniforms, bounce, counts).  Returns the new
    state's fields (``STATE_KEYS`` then ``idx``), the bounce's uniforms and
    ``pos``; only the throughput and the radiance are differentiable.  CUDA
    tensors run the kernels of ``csrc/compact.cu``, CPU tensors the plain
    versions."""

    @staticmethod
    def forward(ctx, throughput, radiance, call):
        st, uniforms, bounce, counts = call
        fn = _forward_cuda if _uses_kernels(throughput) else compact_reference
        out, u, pos = fn(st, uniforms, bounce, counts)
        outputs = tuple(out[k] for k in STATE_KEYS) + (out["idx"], u, pos)
        ctx.mark_non_differentiable(*(x for i, x in enumerate(outputs) if i not in (2, 3)))
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(pos)
        return outputs

    @staticmethod
    def backward(ctx, *grads):
        (pos,) = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        g = tuple(x if n else None for x, n in zip(grads[2:4], need))
        fn = _backward_cuda if _uses_kernels(pos) else compact_backward_reference
        return (*fn(pos, *g), None)


def _uses_kernels(x) -> bool:
    """Whether ``x``'s device runs the kernels of ``csrc/compact.cu`` (a
    CUDA tensor) rather than the plain versions (a CPU tensor)."""
    return x.is_cuda


def _check(st: dict, uniforms, bounce: int, counts=None):
    """Raise on what neither route takes: a missing field, a wrong dtype or
    shape, a bounce outside the block, a tensor on another device, a
    ``counts`` that cannot take the live count, or a gradient K5 does not
    carry.  Each refusal names its input."""
    b = st["active"].shape[0]
    for k, dt in _DTYPES.items():
        x = st.get(k)
        if x is None and k == "idx":
            continue
        if x is None:
            raise ValueError(f"compact: the state has no {k}")
        shape = (b, 3) if k in FLOAT_KEYS else (b,)
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"compact: {k} must be {shape} {dt}")
        if x.device != st["active"].device:
            raise ValueError(f"compact: every input must be on the lanes' device; {k} is not")
    if uniforms.dtype != _F32 or uniforms.dim() != 3 or uniforms.shape[0] != b or uniforms.shape[2] != N_UNIFORMS:
        raise ValueError(f"compact: the uniforms must be ({b}, n_bounces, {N_UNIFORMS}) float32")
    if uniforms.device != st["active"].device:
        raise ValueError("compact: every input must be on the lanes' device; the uniforms are not")
    if not 0 <= bounce < uniforms.shape[1]:
        raise ValueError(f"compact: bounce {bounce} outside the block's {uniforms.shape[1]} bounces")
    if counts is not None and (counts.dtype != _I32 or counts.dim() != 1 or counts.shape[0] < uniforms.shape[1]
                               or counts.device != st["active"].device):
        raise ValueError("compact: counts must be a (n_bounces,) int32 tensor on the lanes' device")
    _check_grad(st, uniforms)


def _check_grad(st: dict, uniforms):
    if torch.is_grad_enabled() and (st["origin"].requires_grad or st["dir"].requires_grad
                                    or uniforms.requires_grad):
        bad = [k for k in ("origin", "dir") if st[k].requires_grad] + (["uniforms"] if uniforms.requires_grad else [])
        raise ValueError(f"compact: K5 carries a gradient only for the throughput and radiance; {bad} require grad")


def compact(st: dict, uniforms, bounce: int, counts=None):
    """The lane state stably partitioned, the live lanes first, for bounce
    ``bounce`` (see the module's text).  ``st`` holds ``STATE_KEYS`` and
    optionally ``idx`` (absent or None: the identity); ``counts``: a
    (n_bounces,) int32 tensor on the lanes' device whose slot ``bounce``
    takes the live count, or None.  Returns (the new state with ``idx``, the
    bounce's (B, N_UNIFORMS) uniforms).

    CUDA tensors launch ``compact_forward`` once, counted in
    ``compact.launches``, and ``compact_backward`` when the gradient is
    taken (``compact.backward_launches``); CPU tensors run the plain
    versions.  Without a gradient to take (grad mode off, or neither the
    throughput nor the radiance requiring grad) no autograd node is made.
    Any other device raises.  On the card the inputs are checked in one
    pass inside the forward (:func:`_forward_cuda`)."""
    dev = st["active"].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"compact: unsupported device {dev}")
    cuda = _uses_kernels(st["active"])
    if cuda:
        _check_grad(st, uniforms)
    else:
        _check(st, uniforms, bounce, counts)
    tp, rad = st["throughput"], st["radiance"]
    if torch.is_grad_enabled() and (tp.requires_grad or rad.requires_grad):
        out = CompactFunction.apply(tp, rad, (st, uniforms, bounce, counts))
        return dict(zip(STATE_KEYS + ("idx",), out[:8])), out[8]
    fn = _forward_cuda if cuda else compact_reference
    out, u, _ = fn(st, uniforms, bounce, counts)
    return out, u


compact.launches = 0
compact.backward_launches = 0


def compact_for_bounce(st: dict, uniforms, bounce: int, counts=None):
    """:func:`compact` as the bounce loop calls it, with its backward folded
    into the next bounce's (see the module's text): the same arguments and
    the same (state, uniforms) out, bit for bit.  Where a gradient is
    carried (grad mode on and the throughput or the radiance requiring
    grad) the compaction makes no autograd node; the state's rows are data,
    and the state gains ``lanes``, a :class:`Lanes` of the incoming
    throughput and radiance with ``src`` (on the card from the same
    ``compact_forward`` launch).  Otherwise it is :func:`compact`."""
    tp, rad = st["throughput"], st["radiance"]
    if not (torch.is_grad_enabled() and (tp.requires_grad or rad.requires_grad)):
        return compact(st, uniforms, bounce, counts)
    dev = st["active"].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"compact: unsupported device {dev}")
    if _uses_kernels(st["active"]):
        _check_grad(st, uniforms)
        fn = _forward_cuda
    else:
        _check(st, uniforms, bounce, counts)
        fn = compact_reference
    with torch.no_grad():
        out, u, _, src = fn(st, uniforms, bounce, counts, with_src=True)
    out["lanes"] = Lanes(tp, rad, src)
    return out, u


class UnpermuteFunction(torch.autograd.Function):
    """The final scatter as an autograd function of the radiance."""

    @staticmethod
    def forward(ctx, radiance, idx):
        ctx.save_for_backward(idx)
        return _unpermute_cuda(radiance, idx, True) if _uses_kernels(radiance) else unpermute_reference(radiance, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        d = _unpermute_cuda(g, idx, False) if _uses_kernels(g) else unpermute_backward_reference(g, idx)
        return d, None


def unpermute(radiance, idx):
    """(B, 3) radiance back in the lanes' own order: row ``idx[j]`` of the
    result is row ``j`` of ``radiance``; ``idx`` (B,) int32 is a permutation
    of 0..B-1, as :func:`compact` carries it.  CUDA tensors launch the
    scatter (``unpermute.launches``) and, with a gradient, the gather back
    (``unpermute.backward_launches``); CPU tensors run the plain versions.
    Any other device raises."""
    b = radiance.shape[0]
    if radiance.dtype != _F32 or radiance.shape != (b, 3):
        raise ValueError("unpermute: the radiance must be (B, 3) float32")
    if idx.dtype != _I32 or idx.shape != (b,) or idx.device != radiance.device:
        raise ValueError(f"unpermute: idx must be a ({b},) int32 tensor on the radiance's device")
    if radiance.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unpermute: unsupported device {radiance.device}")
    if torch.is_grad_enabled() and radiance.requires_grad:
        return UnpermuteFunction.apply(radiance, idx)
    return _unpermute_cuda(radiance, idx, True) if _uses_kernels(radiance) else unpermute_reference(radiance, idx)


unpermute.launches = 0
unpermute.backward_launches = 0


# ---- the CUDA kernels

# compact_forward's slot array (``enum Slot`` of csrc/compact.cu): the
# inputs, the outputs, the scratch, then the uniforms' lane stride and the
# bounce as integers
OUT_KEYS = STATE_KEYS + ("idx", "u")
FORWARD_SLOTS = (STATE_KEYS + ("idx", "uniforms") + tuple(f"out_{k}" for k in OUT_KEYS)
                 + ("pos", "src", "counts", "scratch", "u_lane_stride", "bounce"))
FORWARD_ARRAY = ctypes.c_void_p * len(FORWARD_SLOTS)


@functools.cache
def _library():
    """K5's shared library (the forward, the backward, the unpermute),
    built at first use."""
    from ..utils.cuda_build import load_library

    lib = load_library("compact")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.compact_scratch_words.argtypes = [ci]
    lib.compact_scratch_words.restype = ci
    lib.compact_forward_config.argtypes = [ci, ctypes.POINTER(ci)]
    lib.compact_forward.argtypes = [ci, vp, ci, vp]  # b, slots, slot count, stream
    lib.compact_backward.argtypes = [ci, vp, vp, vp, vp, vp, vp]
    lib.unpermute.argtypes = [ci, vp, vp, vp, ci, vp]
    for fn in (lib.compact_forward_config, lib.compact_forward, lib.compact_backward, lib.unpermute):
        fn.restype = ci
    lib.compact_error_string.argtypes = [ci]
    lib.compact_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, fn, device_index: int, *args):
    rc = on_current_stream(fn, device_index, *args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {_library().compact_error_string(rc).decode()}")


def launch_config(b: int, device=None) -> dict:
    """How ``compact_forward`` launches on ``b`` lanes on the current card
    (or ``device``): {"threads", "tile" (lanes per tile), "blocks",
    "smem_bytes" (per block), "resident_blocks_per_sm", "sms",
    "registers" (per thread)}."""
    lib = _library()
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        rc = lib.compact_forward_config(b, out)
    if rc != 0:
        raise RuntimeError(f"compact_forward launch configuration failed: {lib.compact_error_string(rc).decode()}")
    return dict(zip(("threads", "tile", "blocks", "smem_bytes", "resident_blocks_per_sm", "sms", "registers"), out))


# per card: the forward's scratch buffers (control words and one status
# word per tile), zero when allocated, the newest last; the kernel leaves
# a buffer ready for the next call.  A buffer outgrown stays allocated: a
# CUDA graph captured with it replays against it, and plans made with it
# keep using it.
_SCRATCH: dict = {}


def _scratch(dev, words: int):
    """The scratch of card ``dev`` of at least ``words`` 64-bit words: calls
    on one card share it, and so must run on one stream, one after another.
    It grows outside a CUDA graph capture only (a capture would record the
    fill and leave the buffer unset until a replay); a capture needs one
    eager call of at least its size first."""
    bufs = _SCRATCH.setdefault(dev.index, [])
    if not bufs or bufs[-1].numel() < words:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("compact: the scratch must be allocated before a CUDA graph capture; run one call of "
                               "this batch size outside the capture first")
        bufs.append(torch.zeros(max(words, 512), dtype=torch.int64, device=dev))
    return bufs[-1]


# the forward's outputs carved from one buffer: (key, row width, dtype),
# each part starting on a 16-byte boundary.  The throughput, pos and src,
# which a gradient's autograd nodes save (K4's, the next-event half's, K5's
# own), are allocations of their own, so that saving them keeps nothing
# else of a bounce alive.
_PARTS = (("origin", 3, _F32), ("dir", 3, _F32), ("radiance", 3, _F32), ("u", N_UNIFORMS, _F32),
          ("cur_mat", 1, _I32), ("idx", 1, _I32), ("active", 1, _BOOL), ("specular", 1, _BOOL))
_DTYPE_INDEX = {_F32: 0, _I32: 1, _BOOL: 2}


class _Plan(NamedTuple):
    """What every forward call of one (lanes, bounces, card) shares."""

    expected: tuple  # (dtype, shape) of STATE_KEYS' fields
    u_shape: torch.Size  # the uniform block's
    n_bytes: int  # the carved outputs' buffer
    parts: tuple  # (key, element offset, shape, stride, dtype index) of each carved output
    offsets: dict  # key -> byte offset of each carved output
    scratch: torch.Tensor
    scratch_ptr: int


@functools.lru_cache(maxsize=64)
def _plan(b: int, n_bounces: int, dev) -> _Plan:
    """The forward's plan for ``b`` lanes of a block of ``n_bounces`` bounces
    on card ``dev``, made once: the expected input shapes, the carved
    layout and the card's scratch."""
    scratch = _scratch(dev, _library().compact_scratch_words(b))
    parts, offsets, end = [], {}, 0
    for k, width, dt in _PARTS:
        shape, stride = ((b, width), (width, 1)) if width > 1 else ((b,), (1,))
        parts.append((k, end // dt.itemsize, shape, stride, _DTYPE_INDEX[dt]))
        offsets[k] = end
        end = (end + b * width * dt.itemsize + 15) // 16 * 16
    expected = tuple((_DTYPES[k], torch.Size((b, 3) if k in FLOAT_KEYS else (b,))) for k in STATE_KEYS)
    return _Plan(expected, torch.Size((b, n_bounces, N_UNIFORMS)), max(end, 16), tuple(parts), offsets, scratch,
                 scratch.data_ptr())


def _dense_rows(x):
    return x if x.is_contiguous() else x.contiguous()


def _checked_inputs(st: dict, uniforms, bounce: int, counts, plan: _Plan, dev) -> tuple:
    """The forward's inputs checked in one pass: (the state fields in
    ``STATE_KEYS``' order, ``idx`` or None, the uniforms), each as the
    kernel reads it (dense; the uniforms with a dense row).  A wrong input
    raises naming it."""
    try:
        ins = tuple(st[k] for k in STATE_KEYS)
    except KeyError:
        _check(st, uniforms, bounce, counts)  # raises naming the missing field
    idx = st.get("idx")
    if (tuple((x.dtype, x.shape) for x in ins) == plan.expected and uniforms.dtype == _F32
            and uniforms.shape == plan.u_shape and uniforms.stride(2) == 1 and uniforms.stride(1) == N_UNIFORMS
            and all(x.device == dev and x.is_contiguous() for x in ins)
            and uniforms.device == dev and 0 <= bounce < plan.u_shape[1]
            and (idx is None or (idx.dtype == _I32 and idx.shape == ins[4].shape and idx.device == dev
                                 and idx.is_contiguous()))
            and (counts is None or (counts.dtype == _I32 and counts.dim() == 1 and counts.shape[0] >= plan.u_shape[1]
                                    and counts.device == dev))):
        return ins, idx, uniforms
    _check(st, uniforms, bounce, counts)  # raises naming the input at fault
    if uniforms.stride(2) != 1 or uniforms.stride(1) != N_UNIFORMS:
        uniforms = uniforms.contiguous()
    return tuple(map(_dense_rows, ins)), None if idx is None else _dense_rows(idx), uniforms


def _forward_cuda(st: dict, uniforms, bounce: int, counts, with_src: bool = False):
    """``compact_forward`` on the card: the plan of this batch size, the
    inputs checked in one pass, the outputs three allocations (the carved
    buffer, the throughput, ``pos``; ``src`` a fourth where ``with_src``),
    one entry-point call.  Returns (state, uniforms, pos), and src last
    where ``with_src``."""
    dev = st["active"].device
    b = st["active"].shape[0]
    if b >= 2**31 - 1:
        raise ValueError("compact: too many lanes for one launch")
    plan = _plan(b, uniforms.shape[1] if uniforms.dim() == 3 else 0, dev)
    ins, idx, u = _checked_inputs(st, uniforms, bounce, counts, plan, dev)
    if counts is None:
        counts = torch.empty((plan.u_shape[1],), dtype=_I32, device=dev)
    buf = torch.empty((plan.n_bytes,), dtype=torch.uint8, device=dev)
    typed = (buf.view(_F32), buf.view(_I32), buf.view(_BOOL))
    out = {k: typed[kind].as_strided(shape, stride, off) for k, off, shape, stride, kind in plan.parts}
    out["throughput"] = tp = torch.empty((b, 3), dtype=_F32, device=dev)
    pos = torch.empty((b,), dtype=_I32, device=dev)
    src = torch.empty((b,), dtype=_I32, device=dev) if with_src else None
    base, offsets = buf.data_ptr(), plan.offsets
    slots = FORWARD_ARRAY(*(x.data_ptr() for x in ins), None if idx is None else idx.data_ptr(), u.data_ptr(),
                          *(tp.data_ptr() if k == "throughput" else base + offsets[k] for k in OUT_KEYS),
                          pos.data_ptr(), None if src is None else src.data_ptr(), counts.data_ptr(),
                          plan.scratch_ptr, u.stride(0), bounce)
    _launch("compact_forward", _library().compact_forward, dev.index, b, slots, len(FORWARD_SLOTS))
    compact.launches += 1
    new = {k: out[k] for k in STATE_KEYS + ("idx",)}
    return (new, out["u"], pos, src) if with_src else (new, out["u"], pos)


def _backward_cuda(pos, g_throughput, g_radiance):
    """``compact_backward`` on the card: both cotangents in one launch."""
    b = pos.shape[0]
    g = [None if x is None else _dense_rows(x) for x in (g_throughput, g_radiance)]
    if g[0] is None and g[1] is None:
        return None, None
    d = [None if x is None else torch.empty((b, 3), dtype=_F32, device=pos.device) for x in g]
    if b > 0:
        ptr = [None if x is None else x.data_ptr() for x in g + d]
        _launch("compact_backward", _library().compact_backward, pos.device.index, b, pos.data_ptr(), *ptr)
        compact.backward_launches += 1
    return tuple(d)


def _unpermute_cuda(x, idx, scatter: bool):
    """The scatter ``out[idx[j]] = x[j]`` (``scatter``) or the gather
    ``out[j] = x[idx[j]]`` on the card, one launch."""
    b = x.shape[0]
    x = _dense_rows(x)
    out = torch.empty((b, 3), dtype=_F32, device=x.device)
    if b > 0:
        _launch("unpermute", _library().unpermute, x.device.index, b, _dense_rows(idx).data_ptr(), x.data_ptr(),
                out.data_ptr(), int(scatter))
        if scatter:
            unpermute.launches += 1
        else:
            unpermute.backward_launches += 1
    return out
