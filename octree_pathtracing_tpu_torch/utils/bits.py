"""Bit utilities (copy of ``utils/bits.py``, numpy as there): the index of
the highest set bit, and the 30-bit values packed into ``u32[8]`` blocks
(the reference's bitstream next to the Minecraft palette format)."""

from __future__ import annotations

import numpy as np

NUM_WORDS = 8
BITS_PER_WORD = 32
CHUNK_BITS = 30
MAX_START = NUM_WORDS * BITS_PER_WORD - CHUNK_BITS


def find_msb_u32(x) -> np.ndarray:
    """Index of the highest set bit; 0xFFFFFFFF for 0."""
    x = np.asarray(x, np.uint32)
    out = np.full(x.shape, np.uint32(0xFFFFFFFF))
    nz = x != 0
    # bit_length - 1 via log2 on float64 is exact for 32-bit ints
    out[nz] = (np.floor(np.log2(x[nz].astype(np.float64)))).astype(np.uint32)
    return out if out.shape else out[()]


def find_msb_i32(x) -> np.ndarray:
    """Signed variant: the msb of ~x for negatives, -1 for 0 and -1."""
    x = np.asarray(x, np.int64)
    v = np.where(x < 0, ~x, x).astype(np.uint32)
    out = np.full(x.shape, -1, np.int32)
    nz = v != 0
    out[nz] = np.floor(np.log2(v[nz].astype(np.float64))).astype(np.int32)
    return out if out.shape else out[()]


def extract_u30(block: np.ndarray, start_bit: int) -> int:
    """Read a 30-bit value from a 256-bit big-endian-ordered u32[8] block."""
    assert 0 <= start_bit <= MAX_START
    block = np.asarray(block, np.uint64)
    word = start_bit // BITS_PER_WORD
    off = start_bit % BITS_PER_WORD
    hi = block[word]
    lo = block[word + 1] if word + 1 < NUM_WORDS else np.uint64(0)
    window = (hi << np.uint64(32)) | lo
    shift = np.uint64(64 - off - CHUNK_BITS)
    return int((window >> shift) & np.uint64((1 << CHUNK_BITS) - 1))


def write_u30(block: np.ndarray, start_bit: int, value: int) -> None:
    """Write a 30-bit value into the block in place."""
    assert 0 <= start_bit <= MAX_START
    assert 0 <= value < (1 << CHUNK_BITS)
    word = start_bit // BITS_PER_WORD
    off = start_bit % BITS_PER_WORD
    hi = np.uint64(block[word])
    lo = np.uint64(block[word + 1]) if word + 1 < NUM_WORDS else np.uint64(0)
    window = (hi << np.uint64(32)) | lo
    shift = np.uint64(64 - off - CHUNK_BITS)
    mask = np.uint64((1 << CHUNK_BITS) - 1) << shift
    window = (window & ~mask) | (np.uint64(value) << shift)
    block[word] = np.uint32(window >> np.uint64(32))
    if word + 1 < NUM_WORDS:
        block[word + 1] = np.uint32(window & np.uint64(0xFFFFFFFF))
