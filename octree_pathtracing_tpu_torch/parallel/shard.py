"""The sharded render and train steps, and the trainable parameters grafted
into a scene with the photometric loss over them (port of
``parallel/shard.py``).

A batch is sample-major, ``(S, B, ...)``: samples over the mesh's ``sp``
axis, lanes over ``dp``.  Each rank holds its ``(S / sp, B / dp)`` block
(``local_block``), runs ``trace_paths`` on it flattened, and takes the mean
over its samples; the render's mean over all samples is then an all-reduce
over ``sp``, and each rank holds its ``dp`` slice of the image
(``assemble_image`` gathers the whole).  The train step takes each rank's
loss and gradients of its block and all-reduces their mean over every rank
in one collective.  Only ``all_reduce`` is used, which the gloo backend
also runs on CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models.scene import Scene
from ..ops.texture import Atlas
from ..render.pathtracer import trace_paths
from .mesh import Mesh


def apply_params(scene: Scene, params: dict) -> Scene:
    """Graft trainable leaves (atlas albedo, material emittance) into a scene.

    ``params["atlas"]`` is either a full atlas (tensor or :class:`Atlas`)
    or, for a variable-resolution scene, just the texel ``data`` tensor (the
    int size table is structural, not trainable).  The scene's
    ``opaque_only`` and ``shadow_binary`` stay as they were built: the
    traversal structure does not follow the trained alphas."""
    atlas = params["atlas"]
    if isinstance(scene.atlas, Atlas) and not isinstance(atlas, Atlas):
        atlas = Atlas(atlas, scene.atlas.sizes)
    materials = dataclasses.replace(scene.materials, emittance=params["emittance"])
    return dataclasses.replace(scene, atlas=atlas, materials=materials)


def render_loss(scene: Scene, params: dict, origins, dirs, uniforms, target) -> torch.Tensor:
    """Photometric MSE with trainable (atlas, emittance) grafted into the
    scene — the inverse-rendering objective."""
    rad = trace_paths(apply_params(scene, params), origins, dirs, uniforms)
    return torch.mean((rad - target) ** 2)


def local_block(mesh: Mesh, x):
    """This rank's ``(S / sp, B / dp, ...)`` block of a sample-major
    ``(S, B, ...)`` array or tensor."""
    s, b = x.shape[:2]
    if s % mesh.sp or b % mesh.dp:
        raise ValueError(f"a ({s}, {b}) batch does not cut into (sp={mesh.sp}, dp={mesh.dp}) blocks")
    s_loc, b_loc = s // mesh.sp, b // mesh.dp
    return x[mesh.sp_index * s_loc:(mesh.sp_index + 1) * s_loc, mesh.dp_index * b_loc:(mesh.dp_index + 1) * b_loc]


def _flat(x):
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _all_reduce_mean(x, group, size: int):
    """The mean of ``x`` over the ``size`` ranks of ``group``, in place
    (nothing to do for one rank)."""
    if size > 1:
        dist.all_reduce(x, group=group)
        x /= size
    return x


def sharded_render(mesh: Mesh, scene: Scene, origins, dirs, uniforms):
    """This rank's ``(B / dp, 3)`` slice of the image: the radiance of its
    ``(S_loc, B_loc)`` block of lanes (``origins`` / ``dirs`` ``(S_loc,
    B_loc, 3)``, ``uniforms`` ``(S_loc, B_loc, n_bounces, 21)``) averaged
    over its samples, then over the ``sp`` axis."""
    s_loc, b_loc = origins.shape[0], origins.shape[1]
    rad = trace_paths(scene, _flat(origins), _flat(dirs), _flat(uniforms))
    rad = rad.reshape(s_loc, b_loc, 3).mean(dim=0)
    return _all_reduce_mean(rad, mesh.sp_group, mesh.sp)


def assemble_image(mesh: Mesh, local):
    """The whole ``(B, 3)`` image on every rank from each rank's ``dp``
    slice: the slices placed in a zero image (one copy per ``dp`` index)
    and summed over every rank."""
    b_loc = local.shape[0]
    full = local.new_zeros((mesh.dp * b_loc,) + tuple(local.shape[1:]))
    if mesh.sp_index == 0:
        full[mesh.dp_index * b_loc:(mesh.dp_index + 1) * b_loc] = local
    if mesh.size > 1:
        dist.all_reduce(full)
    return full


def sharded_train_step(mesh: Mesh, scene: Scene, params: dict, origins, dirs, uniforms, target):
    """One inverse-rendering gradient step on the mesh: (loss, grads) of
    the global mean loss, the same on every rank.  Each rank differentiates
    :func:`render_loss` on its ``(S_loc, B_loc)`` block (``target``
    ``(S_loc, B_loc, 3)``); the losses and the ``atlas`` and ``emittance``
    gradients are averaged over every rank in one all-reduce."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = render_loss(scene, p, _flat(origins), _flat(dirs), _flat(uniforms), _flat(target))
    keys = list(p)
    grads = torch.autograd.grad(loss, [p[k] for k in keys])
    packed = torch.cat([loss.detach().reshape(1)] + [g.reshape(-1) for g in grads])
    _all_reduce_mean(packed, None, mesh.size)
    out, at = {}, 1
    for k, g in zip(keys, grads):
        out[k] = packed[at:at + g.numel()].reshape(g.shape)
        at += g.numel()
    return packed[0], out
