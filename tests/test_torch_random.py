"""Kernel P2's plain version: Philox4x32-10 against Random123's published
answers, P2's bits-to-float map, the statistics of a uniform block, and the
seed + counter draws of ``draw_uniforms`` and the ``Renderer``.  The kernel
against this twin, bit for bit: test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from octree_pathtracing_tpu_torch.models import minecraft_chunk_scene
from octree_pathtracing_tpu_torch.ops.random import (
    bits_to_unit,
    philox4x32_10,
    philox_uniforms,
    philox_uniforms_reference,
)
from octree_pathtracing_tpu_torch.ops.shading import N_UNIFORMS
from octree_pathtracing_tpu_torch.render import Renderer, draw_uniforms

# Random123's known-answer tests for philox4x32-10 (kat_vectors):
# counter (4 words), key (2 words) -> output (4 words)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    got = philox4x32_10(tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(w) for w in got) == want


def test_block_layout_is_word_i_mod_4_of_block_i_div_4():
    seed, counter = 0x1234_5678_9ABC_DEF0, 0x0F0E_0D0C_0B0A_0908
    u = philox_uniforms_reference(seed, counter, 10)
    for blk in range(3):
        ctr = (blk, 0, counter & 0xFFFFFFFF, counter >> 32)
        words = philox4x32_10(tuple(torch.tensor([c], dtype=torch.int64) for c in ctr),
                              (seed & 0xFFFFFFFF, seed >> 32))
        for j, w in enumerate(words):
            if 4 * blk + j < 10:
                assert u[4 * blk + j].item() == bits_to_unit(w).item()


def test_bits_to_float_is_p2s_map():
    """P2 (tools/profile_pallas.py:116-118): bitcast((bits >> 9) | 0x3F800000) - 1."""
    bits = np.array([0, 1, 511, 512, 0x80000000, 0xFFFFFFFF, 0x12345678], np.uint64)
    want = ((bits.astype(np.uint32) >> 9) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    got = bits_to_unit(torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and got.max() == np.float32(1.0) - np.float32(2.0**-23)


def test_block_statistics():
    u = philox_uniforms_reference(7, 3, 1 << 18).numpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 3e-3
    counts = np.histogram(u, bins=16, range=(0.0, 1.0))[0]
    expected = u.size / 16
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 37.7  # the 0.999 quantile of chi-square with 15 degrees of freedom
    # neighbouring outputs are uncorrelated
    assert abs(np.corrcoef(u[:-1], u[1:])[0, 1]) < 0.01


def test_counters_and_seeds_give_disjoint_streams():
    a = philox_uniforms_reference(11, 0, 4096).numpy()
    b = philox_uniforms_reference(11, 1, 4096).numpy()
    c = philox_uniforms_reference(12, 0, 4096).numpy()
    assert len(np.intersect1d(a, b)) < 5 and len(np.intersect1d(a, c)) < 5
    # a draw is a pure function of (seed, counter): prefixes agree, no state
    np.testing.assert_array_equal(philox_uniforms_reference(11, 0, 1001).numpy(), a[:1001])
    np.testing.assert_array_equal(philox_uniforms(11, 1, 4096, "cpu").numpy(), b)


def test_wrapper_checks_and_empty_draw():
    assert philox_uniforms(0, 0, 0, "cpu").shape == (0,)
    before = philox_uniforms.launches
    philox_uniforms(0, 0, 33, "cpu")
    assert philox_uniforms.launches == before  # the CPU runs the twin
    for bad in (dict(seed=-1), dict(seed=2**64), dict(counter=-1), dict(n=-1)):
        kw = dict(seed=0, counter=0, n=4, device="cpu") | bad
        with pytest.raises(ValueError):
            philox_uniforms(**kw)
    with pytest.raises(ValueError, match="unsupported device"):
        philox_uniforms(0, 0, 4, "meta")


def test_draw_uniforms_block():
    u = draw_uniforms(5, 9, 100, 3, "cpu")
    assert u.shape == (100, 3, N_UNIFORMS) and u.dtype == torch.float32
    np.testing.assert_array_equal(u.reshape(-1).numpy(), philox_uniforms_reference(5, 9, 100 * 3 * N_UNIFORMS).numpy())


def test_renderer_draws_are_reproducible_and_advance():
    scene, cam = minecraft_chunk_scene(depth=3)
    frames = []
    for _ in range(2):
        r = Renderer(scene=scene, camera=cam, width=8, height=6, target_spp=3, branch_count=2, seed=4)
        counters = [r.counter]
        while r.step():
            counters.append(r.counter)
        frames.append(r.framebuffer)
    torch.testing.assert_close(frames[0], frames[1], rtol=0, atol=0)
    assert counters == [0, 2, 4, 6]  # three 1-sample passes: two streams per sample
    r = Renderer(scene=scene, camera=cam, width=8, height=6, target_spp=3, branch_count=2, seed=5)
    while r.step():
        pass
    assert not torch.equal(r.framebuffer, frames[0])
