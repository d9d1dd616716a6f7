"""The reference's bounce loop: every lane in its own row for the whole
path, no compaction and no unpermute, each bounce through the plain walk,
the plain shading and the plain next-event half.

A compaction only moves rows, so each lane's radiance is the one the port
computes after its compactions and its final unpermute; this loop is what
they have to preserve.  ``round_state`` (the precision control) is called
on the state after every bounce.
"""

from __future__ import annotations

import torch

from ..models.scene import MAX_DIST, Scene
from ..ops.nee import nee_plan, nee_reference
from ..ops.shade import shade_reference
from ..ops.traversal import traverse, traverse_alpha
from .hit import accept_tables


def walk(scene: Scene, origins, dirs, active=None):
    """First accepted hit of every lane, detached: the plain K1 walk on
    all-opaque scenes, the plain in-loop alpha accept otherwise."""
    args = (scene.nodes, scene.root, scene.depth, scene.octree_scale,
            origins.detach().contiguous(), dirs.detach().contiguous())
    if scene.opaque_only:
        return traverse(*args, MAX_DIST, active)
    return traverse_alpha(*args, accept_tables(scene), MAX_DIST, active)


def init_state(origins, dirs):
    b, dev = origins.shape[0], origins.device
    return dict(
        origin=origins.to(torch.float32),
        dir=dirs.to(torch.float32),
        throughput=torch.ones((b, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((b, 3), dtype=torch.float32, device=dev),
        active=torch.ones((b,), dtype=torch.bool, device=dev),
        specular=torch.ones((b,), dtype=torch.bool, device=dev),
        cur_mat=torch.zeros((b,), dtype=torch.int32, device=dev),
    )


def trace_paths(scene: Scene, origins, dirs, uniforms, round_state=None):
    """(B, 3) radiance of every lane: ``uniforms`` (B, n_bounces, 21), row
    ``b`` of a lane driving its bounce ``b``.  Differentiable in the
    scene's atlas and emittance by autograd."""
    n_bounces = uniforms.shape[1]
    light = nee_plan(scene) is not None
    st = init_state(origins, dirs)
    for b in range(n_bounces):
        res = walk(scene, st["origin"], st["dir"], None if b == 0 else st["active"])
        u = uniforms[:, b]
        out, _ = shade_reference(scene, st, u, res, None, b == 0, b + 1 < n_bounces)
        radiance = nee_reference(scene, st, u, out)[0] if light else out.state["radiance"]
        st = dict(out.state, radiance=radiance)
        if round_state is not None:
            st = round_state(st)
    return st["radiance"]
