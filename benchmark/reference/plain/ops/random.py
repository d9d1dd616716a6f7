"""Counter-based uniforms: kernel P2 (CUDA, ``csrc/uniforms.cu``), its
plain-torch twin, and the wrapper that picks between them by device.

Port of the Pallas ``probe_rng`` kernel of ``tools/profile_pallas.py``
(:114, called at :122): 32 random bits per element, mapped to [0, 1) as
``bitcast((bits >> 9) | 0x3F800000) - 1.0``.  The bits come from
Philox4x32-10 with key = the 64-bit ``seed`` and counter = (block index,
``counter``): output ``i`` is word ``i % 4`` of block ``i // 4``.  A draw is
a pure function of ``(seed, counter, n)`` — no generator state — so
different counters give disjoint streams.

The twin does the same in int64 arithmetic: the high word of a 32x32
product is ``(a * b >> 32) & 0xFFFFFFFF``, which stays right when the int64
product wraps.  Kernel and twin agree bit for bit.
"""

from __future__ import annotations


import torch


_MASK = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding uint32 words.

    ``counter``: four tensors (c0, c1, c2, c3); ``key``: two Python ints.
    Returns the four output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK
            k1 = (k1 + PHILOX_W[1]) & _MASK
        p0 = c0 * PHILOX_M[0]
        p1 = c2 * PHILOX_M[1]
        hi0, lo0 = (p0 >> 32) & _MASK, p0 & _MASK
        hi1, lo1 = (p1 >> 32) & _MASK, p1 & _MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_unit(bits):
    """P2's map of 32 random bits (int64 tensor) to a float32 in [0, 1)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _check_args(seed: int, counter: int, n: int):
    if not 0 <= int(seed) < 2**64:
        raise ValueError(f"philox_uniforms: seed {seed} outside [0, 2^64)")
    if not 0 <= int(counter) < 2**64:
        raise ValueError(f"philox_uniforms: counter {counter} outside [0, 2^64)")
    if int(n) < 0:
        raise ValueError(f"philox_uniforms: negative size {n}")


def philox_uniforms_reference(seed: int, counter: int, n: int, device="cpu"):
    """Plain-torch twin of kernel P2 (any device): (n,) float32."""
    _check_args(seed, counter, n)
    seed, counter, n = int(seed), int(counter), int(n)
    block = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    words = philox4x32_10(
        (block & _MASK, (block >> 32) & _MASK,
         torch.full_like(block, counter & _MASK), torch.full_like(block, counter >> 32)),
        (seed & _MASK, seed >> 32),
    )
    return bits_to_unit(torch.stack(words, dim=1).reshape(-1)[:n])


