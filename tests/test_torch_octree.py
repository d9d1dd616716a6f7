"""The port's own numpy octree builder against the JAX package's: the same
node pool (``child_mask``, ``child_data``, ``root``, ``depth``) from the
same dense grid, and the same procedural grids."""

import numpy as np
import pytest

from octree_pathtracing_tpu.models.procedural import cutout_terrain_grid as jax_cutout_grid
from octree_pathtracing_tpu.models.procedural import terrain_grid as jax_terrain_grid
from octree_pathtracing_tpu.octree import build_from_dense as jax_build
from octree_pathtracing_tpu.octree import morton_order_dense as jax_morton_order_dense
from octree_pathtracing_tpu_torch.models import cutout_terrain_grid, terrain_grid
from octree_pathtracing_tpu_torch.octree import Octree, build_from_dense, morton_order_dense


def _sphere_grid(depth):
    s = 1 << depth
    grid = np.zeros((s, s, s), np.uint32)
    grid[:, 0 : max(1, s // 16), :] = 1
    c = np.array([s / 2, s / 2.5, s / 2])
    xs, ys, zs = np.meshgrid(np.arange(s), np.arange(s), np.arange(s), indexing="ij")
    grid[(xs + 0.5 - c[0]) ** 2 + (ys + 0.5 - c[1]) ** 2 + (zs + 0.5 - c[2]) ** 2 < (s / 4.5) ** 2] = 2
    return grid


def _cornell_grid(depth):
    s = 1 << depth
    grid = np.zeros((s, s, s), np.uint32)
    grid[:, 0, :] = grid[:, s - 1, :] = grid[:, :, s - 1] = 1
    grid[0, :, :] = 2
    grid[s - 1, :, :] = 3
    q = s // 4
    grid[q : 2 * q, 1 : s // 2, s // 2 : s // 2 + q] = 5
    return grid


def _random_grid(depth, seed, fill):
    rng = np.random.default_rng(seed)
    s = 1 << depth
    return ((rng.random((s, s, s)) < fill) * rng.integers(1, 6, (s, s, s))).astype(np.uint32)


GRIDS = {
    "sphere": lambda: _sphere_grid(5),
    "cornell": lambda: _cornell_grid(5),
    "terrain": lambda: terrain_grid(5),
    "random_sparse": lambda: _random_grid(4, 1, 0.1),
    "random_dense": lambda: _random_grid(3, 2, 0.9),
    "uniform": lambda: np.full((8, 8, 8), 3, np.uint32),
    "empty": lambda: np.zeros((4, 4, 4), np.uint32),
    "single_voxel": lambda: np.pad(np.ones((1, 1, 1), np.uint32), ((0, 1), (0, 1), (0, 1))),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_builder_matches_jax(name):
    grid = GRIDS[name]()
    got, want = build_from_dense(grid), jax_build(grid)
    assert isinstance(got, Octree)
    np.testing.assert_array_equal(got.child_mask, np.asarray(want.child_mask))
    np.testing.assert_array_equal(got.child_data, np.asarray(want.child_data))
    assert (got.root, got.depth, got.n_nodes, got.scale()) == (want.root, want.depth, want.n_nodes, want.scale())
    assert got.child_mask.dtype == np.uint32 and got.child_data.dtype == np.uint32


def test_morton_order_matches_jax():
    grid = _random_grid(3, 5, 0.5)
    np.testing.assert_array_equal(morton_order_dense(grid), jax_morton_order_dense(grid))
    with pytest.raises(ValueError):
        morton_order_dense(np.zeros((6, 6, 6), np.uint32))


@pytest.mark.parametrize("depth", [3, 5])
def test_procedural_grids_match_jax(depth):
    np.testing.assert_array_equal(terrain_grid(depth, seed=2), jax_terrain_grid(depth, seed=2))
    np.testing.assert_array_equal(cutout_terrain_grid(depth), jax_cutout_grid(depth))


def test_cutout_grid_refuses_depth_2_like_the_reference():
    # rng.integers(2, s - 3) with s = 4 has an empty range (ROADMAP section 3)
    for fn in (cutout_terrain_grid, jax_cutout_grid):
        with pytest.raises(ValueError):
            fn(2)
