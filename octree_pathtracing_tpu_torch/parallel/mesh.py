"""The (dp, sp) grid of ranks the sharded steps run on (port of
``parallel/mesh.py``).

- axis ``dp`` (data / pixel): the pixel lanes are cut across ranks;
- axis ``sp`` (sample): the samples per pixel are cut across ranks.

The scene is replicated on every rank.  Rank ``r`` sits at
``(r // sp, r % sp)``, the row-major order of JAX's device grid; the
sample mean is an all-reduce over the rank's ``sp`` group, the training
gradients an all-reduce over every rank.  ``sp`` is 2 where the world size
is even and at least 4, else 1, as ``make_mesh`` factors devices.

The ``sp`` groups are ``torch.distributed`` subgroups of the default process
group (``parallel/distributed.init_distributed``), made once for each
(process group, ``sp``) and kept, so that a mesh made again for every step
makes no new group; a world of one rank needs no process group, and a
group of one rank does no collective.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

DP_AXIS = "dp"
SP_AXIS = "sp"

_sp_groups: dict = {}  # (default process group, sp) -> this rank's sp group


def mesh_shape(n: int, sp: int | None = None) -> tuple[int, int]:
    """(dp, sp) of ``n`` ranks: ``sp`` 2 where ``n`` is even and at least
    4, else 1, unless given."""
    if sp is None:
        sp = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // sp
    if dp * sp != n:
        raise ValueError(f"cannot factor {n} ranks into (dp={dp}, sp={sp})")
    return dp, sp


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (dp, sp) grid and its ``sp`` group (the
    ranks that share its lanes; None where that is one rank)."""

    dp: int
    sp: int
    rank: int
    sp_group: object = None

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp


def make_mesh(n_devices: int | None = None, sp: int | None = None) -> Mesh:
    """The (dp, sp) grid over every rank of the default process group (one
    rank where none is initialized).  ``n_devices``, where given, must be
    the world size.  Every rank must call it, in the same order as its other
    group creations: ``new_group`` is collective.  The groups are made on
    the first call for a given ``sp`` and reused after it."""
    up = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if up else 1
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh: {n_devices} ranks asked for, the world has {n}")
    dp, sp = mesh_shape(n, sp)
    rank = dist.get_rank() if up else 0
    sp_group = None
    if up and sp > 1:
        world = dist.group.WORLD
        if (world, sp) not in _sp_groups:
            for key in [k for k in _sp_groups if k[0] is not world]:  # a destroyed group's
                del _sp_groups[key]
            for d in range(dp):  # every rank creates every group
                g = dist.new_group([d * sp + s for s in range(sp)])
                if d == rank // sp:
                    _sp_groups[world, sp] = g
        sp_group = _sp_groups[world, sp]
    return Mesh(dp=dp, sp=sp, rank=rank, sp_group=sp_group)
