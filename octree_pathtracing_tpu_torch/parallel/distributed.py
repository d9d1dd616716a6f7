"""Multi-process runtime (port of ``parallel/distributed.py``) over
``torch.distributed``.

- every rank calls :func:`init_distributed` at start, with the backend
  named by the caller (``gloo`` on the CPU, and for ranks that share one
  card; nothing switches backends by itself);
- :func:`make_global_mesh` lays the ranks out on the (dp, sp) grid;
- :func:`global_ray_batch` keeps this rank's block of a sample-major batch;
- the sharded steps of ``parallel/shard.py`` then run unchanged.

:func:`spawn_ranks` starts ranks on one host with ``torch.multiprocessing``
(each gets ``tcp://localhost:<port>`` and its rank) and runs a
module-level function of the caller's in each.  A caller on a card builds
every kernel library before it spawns ranks, so that no two ranks build
into ``build/`` at once.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh
from .shard import local_block


def init_distributed(backend: str, init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None) -> dict:
    """Join this process to the default process group.

    ``world_size`` and ``rank`` default to the ``WORLD_SIZE`` and ``RANK``
    environment variables, ``init_method`` to ``env://`` (which reads
    ``MASTER_ADDR`` and ``MASTER_PORT``).  A world of one rank initializes
    nothing; a process already in a group joins no other.  Returns
    {"rank", "world_size", "backend"}."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size > 1 and not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank)
    if dist.is_initialized():
        return {"rank": dist.get_rank(), "world_size": dist.get_world_size(), "backend": dist.get_backend()}
    return {"rank": 0, "world_size": 1, "backend": None}


def make_global_mesh(sp: int | None = None) -> Mesh:
    """The (dp, sp) grid over every rank of the process group: the JAX
    package's name for :func:`~.mesh.make_mesh`, kept so that callers of
    either package read the same."""
    return make_mesh(sp=sp)


def global_ray_batch(mesh: Mesh, arrays, device=None) -> tuple:
    """This rank's ``(S / sp, B / dp, ...)`` rows of each sample-major array
    or tensor of ``arrays``, as contiguous tensors on ``device``: no rank
    keeps another's rows."""
    def local(x):
        x = local_block(mesh, x)
        x = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        return x.to(device).contiguous()

    return tuple(local(x) for x in arrays)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world_size: int, backend: str, port: int, out_dir: str, args: tuple):
    init_distributed(backend, f"tcp://localhost:{port}", world_size, rank)
    try:
        result = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, backend: str, args: tuple = (), timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``world_size`` spawned processes that form one
    process group on this host (``backend``, ``tcp://localhost`` on a free
    port); returns each rank's result, in rank order.  ``fn`` and its
    arguments must pickle; a rank that fails raises here, and ranks still
    running after ``timeout`` seconds are stopped and raise TimeoutError."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.spawn(_rank_main, args=(fn, world_size, backend, _free_port(), out_dir, args), nprocs=world_size,
                       join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.terminate()
                    p.join()
                raise TimeoutError(f"spawn_ranks: the ranks ran past {timeout} s")
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results

