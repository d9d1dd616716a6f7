"""What each spawned rank of the sharded tests runs (``spawn_ranks`` needs a
module-level function, and this module imports no jax so that a rank
starts quickly): the sharded render and train step of the port on the
layouts asked for, with their results as numpy.

Used by tests/test_torch_parallel.py (the CPU) and tests/test_torch_gpu.py
(two ranks sharing the card)."""

import torch
import torch.distributed as dist

from octree_pathtracing_tpu_torch.ops.texture import Atlas
from octree_pathtracing_tpu_torch.parallel import (assemble_image, global_ray_batch, make_mesh, sharded_render,
                                                   sharded_train_step)


def rank_steps(scene, origins, dirs, uniforms, target, render_sp, train_sp, device):
    """:func:`sharded_render` of the sample-major batch (``origins`` /
    ``dirs`` (S, B, 3), ``uniforms`` (S, B, n_bounces, 21)) on the mesh of
    each ``sp`` of ``render_sp``, the whole image assembled, and
    :func:`sharded_train_step` against ``target`` (S, B, 3) on the mesh of
    each ``sp`` of ``train_sp``, the parameters the scene's (atlas,
    emittance), all on ``device``.  The batch comes whole and each rank
    keeps its block.  Returns {"rank", "render": {sp: image}, "train": {sp:
    (loss, grads)}, "same_group": {sp: whether a mesh made again kept the
    render mesh's sp group}}."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    scene = scene.to(dev)
    out = {"rank": dist.get_rank(), "render": {}, "train": {}, "same_group": {}}
    for sp in render_sp:
        mesh = make_mesh(sp=sp)
        o, d, u = global_ray_batch(mesh, (origins, dirs, uniforms), dev)
        out["render"][sp] = assemble_image(mesh, sharded_render(mesh, scene, o, d, u)).cpu().numpy()
        out["same_group"][sp] = make_mesh(sp=sp).sp_group is mesh.sp_group
    atlas = scene.atlas.data if isinstance(scene.atlas, Atlas) else scene.atlas
    params = {"atlas": atlas, "emittance": scene.materials.emittance}
    for sp in train_sp:
        mesh = make_mesh(sp=sp)
        o, d, u, tgt = global_ray_batch(mesh, (origins, dirs, uniforms, target), dev)
        loss, grads = sharded_train_step(mesh, scene, params, o, d, u, tgt)
        out["train"][sp] = (float(loss), {k: g.cpu().numpy() for k, g in grads.items()})
    return out
