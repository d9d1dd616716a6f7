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

from typing import NamedTuple

import torch

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
