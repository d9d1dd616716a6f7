from .distributed import global_ray_batch, init_distributed, make_global_mesh, spawn_ranks
from .mesh import DP_AXIS, SP_AXIS, Mesh, make_mesh, mesh_shape
from .shard import apply_params, assemble_image, local_block, render_loss, sharded_render, sharded_train_step

__all__ = [
    "DP_AXIS",
    "SP_AXIS",
    "Mesh",
    "apply_params",
    "assemble_image",
    "global_ray_batch",
    "init_distributed",
    "local_block",
    "make_global_mesh",
    "make_mesh",
    "mesh_shape",
    "render_loss",
    "sharded_render",
    "sharded_train_step",
    "spawn_ranks",
]
