"""Kernel P1's plain-torch twins (``ops/gather.py``) against the Pallas
kernel they port, ``k_smem_loop`` of ``tools/profile_pallas.py`` (:67-72),
run in interpret mode on the CPU; and the two-table twin, which the emitter
pick calls, against two single gathers.  The kernel against the twins, bit
for bit: test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from octree_pathtracing_tpu_torch.ops.gather import (
    row_gather,
    row_gather_pair,
    row_gather_pair_reference,
    row_gather_reference,
)


def _pallas_gather(table, idx):
    """``k_smem_loop`` as tools/profile_pallas.py:67-72 writes it (it is
    nested in ``probe_gather`` there, so the body is copied), on an int32
    table, in interpret mode."""
    b, w = idx.shape[0], table.shape[1]

    def k_smem_loop(idx_ref, table_ref, out_ref):
        def body(i, _):
            out_ref[pl.ds(i, 1), :] = table_ref[pl.ds(idx_ref[i], 1), :]
            return 0

        jax.lax.fori_loop(0, b, body, 0)

    out = pl.pallas_call(
        k_smem_loop,
        out_shape=jax.ShapeDtypeStruct((b, w), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(idx), jnp.asarray(table))
    return np.asarray(out)


def _words(rng, n_rows, width):
    return rng.integers(-2**31, 2**31 - 1, (n_rows, width), dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("width", [8, 3])
def test_twins_equal_pallas_k_smem_loop(width):
    rng = np.random.default_rng(40 + width)
    n_rows = 1024
    grid_idx, grid_w = _words(rng, n_rows, width), _words(rng, n_rows, width)
    idx = rng.integers(-n_rows, n_rows, 64).astype(np.int32)
    # past the end both clamp to the last row; [-N, -1] wraps to idx + N, as
    # in jnp indexing, and below -N the wrapped index clamps to row 0
    idx[:6] = [n_rows, n_rows + 9, -1, -n_rows, -n_rows - 1, -3 * n_rows]
    want_i, want_w = _pallas_gather(grid_idx, idx), _pallas_gather(grid_w, idx)
    np.testing.assert_array_equal(want_i, grid_idx[np.clip(np.where(idx < 0, idx + n_rows, idx), 0, n_rows - 1)])
    a = torch.from_numpy(grid_idx)
    b = torch.from_numpy(grid_w).view(torch.float32)  # as grid_w: float32 rows, copied as bits
    for i in (torch.from_numpy(idx), torch.from_numpy(idx).long()):
        np.testing.assert_array_equal(row_gather_reference(a, i).numpy(), want_i)
        np.testing.assert_array_equal(row_gather(b, i).view(torch.int32).numpy(), want_w)
        got_i, got_w = row_gather_pair_reference(a, b, i)
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_array_equal(got_w.view(torch.int32).numpy(), want_w)


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("width", [8, 3])
@pytest.mark.parametrize("dtypes", [(torch.int32, torch.float32), (torch.float32, torch.float32)])
def test_pair_twin_equals_two_single_gathers(dtypes, width, index_dtype):
    rng = np.random.default_rng(width)
    n_rows = 300
    a = torch.from_numpy(_words(rng, n_rows, width)).view(dtypes[0])
    b = torch.from_numpy(_words(rng, n_rows, width)).view(dtypes[1])
    idx = torch.from_numpy(rng.integers(-n_rows - 4, n_rows + 4, 1000)).to(index_dtype)
    idx[:3] = torch.tensor([-1, n_rows, -n_rows - 1])  # -1 wraps, both ends clip
    before = row_gather.launches
    for fn in (row_gather_pair, row_gather_pair_reference):
        got_a, got_b = fn(a, b, idx)
        for got, table in ((got_a, a), (got_b, b)):
            assert got.dtype == table.dtype and got.shape == (1000, width)
            assert torch.equal(got.view(torch.int32), row_gather_reference(table, idx).view(torch.int32))
            assert torch.equal(got.view(torch.int32), row_gather(table, idx).view(torch.int32))
        assert torch.equal(got_a.view(torch.int32)[:3], a.view(torch.int32)[[n_rows - 1, n_rows - 1, 0]])
    assert row_gather.launches == before  # the CPU runs the twins


def test_pair_refuses_what_no_path_takes():
    a = torch.zeros((16, 8), dtype=torch.int32)
    idx = torch.arange(4)
    with pytest.raises(ValueError, match="one shape"):
        row_gather_pair(a, torch.zeros((16, 4), dtype=torch.float32), idx)
    with pytest.raises(ValueError, match="int32 or float32"):
        row_gather_pair(a, a.double(), idx)
    with pytest.raises(ValueError, match="integer"):
        row_gather_pair(a, a, idx.float())
    with pytest.raises(ValueError, match="unsupported device"):
        row_gather_pair(a.to("meta"), a.to("meta"), idx.to("meta"))
