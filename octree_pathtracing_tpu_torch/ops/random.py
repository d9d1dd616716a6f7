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

import ctypes
import functools

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


@functools.cache
def _library():
    """P2's shared library, built at first use."""
    from ..utils.cuda_build import load_library

    lib = load_library("uniforms")
    vp, ci, cu, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
    lib.philox_uniforms.argtypes = [vp, cll, cu, cu, cu, cu, vp]
    lib.philox_uniforms.restype = ci
    lib.philox_error_string.argtypes = [ci]
    lib.philox_error_string.restype = ctypes.c_char_p
    return lib


def _philox_cuda(seed: int, counter: int, n: int, device):
    out = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0:  # an empty draw launches nothing
        return out
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.philox_uniforms(
            out.data_ptr(), n, seed & _MASK, seed >> 32, counter & _MASK, counter >> 32, stream
        )
    if rc != 0:
        raise RuntimeError(f"philox_uniforms launch failed: {lib.philox_error_string(rc).decode()}")
    philox_uniforms.launches += 1
    return out


def philox_uniforms(seed: int, counter: int, n: int, device="cuda"):
    """``n`` uniforms in [0, 1) as a (n,) float32 tensor on ``device``.

    A CUDA device launches kernel P2 (``csrc/uniforms.cu``) and counts the
    launch in ``philox_uniforms.launches``; the CPU runs
    :func:`philox_uniforms_reference`.  Any other device raises."""
    _check_args(seed, counter, n)
    device = torch.device(device)
    if device.type == "cuda":
        return _philox_cuda(int(seed), int(counter), int(n), device)
    if device.type == "cpu":
        return philox_uniforms_reference(seed, counter, n, device)
    raise ValueError(f"philox_uniforms: unsupported device {device}")


philox_uniforms.launches = 0
