"""Minimal NBT (Named Binary Tag) reader and writer (copy of
``octree_pathtracing_tpu/models/nbt.py``).

The reader returns plain Python dicts and lists, with numpy arrays for the
array tags; long arrays decode straight into ``int64`` (the palette-index
unpack in ``mca.py`` is vectorized).  The writer synthesizes region files
for tests and for ``mca.make_region_fixture``.
"""

from __future__ import annotations

import struct

import numpy as np

TAG_END = 0
TAG_BYTE = 1
TAG_SHORT = 2
TAG_INT = 3
TAG_LONG = 4
TAG_FLOAT = 5
TAG_DOUBLE = 6
TAG_BYTE_ARRAY = 7
TAG_STRING = 8
TAG_LIST = 9
TAG_COMPOUND = 10
TAG_INT_ARRAY = 11
TAG_LONG_ARRAY = 12


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self):
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def be(self, fmt, size):
        v = struct.unpack_from(fmt, self.buf, self.pos)[0]
        self.pos += size
        return v

    def string(self):
        n = self.be(">H", 2)
        s = self.buf[self.pos : self.pos + n].decode("utf-8", "replace")
        self.pos += n
        return s

    def payload(self, tag):
        if tag == TAG_BYTE:
            return self.be(">b", 1)
        if tag == TAG_SHORT:
            return self.be(">h", 2)
        if tag == TAG_INT:
            return self.be(">i", 4)
        if tag == TAG_LONG:
            return self.be(">q", 8)
        if tag == TAG_FLOAT:
            return self.be(">f", 4)
        if tag == TAG_DOUBLE:
            return self.be(">d", 8)
        if tag == TAG_BYTE_ARRAY:
            n = self.be(">i", 4)
            a = np.frombuffer(self.buf, np.int8, n, self.pos).copy()
            self.pos += n
            return a
        if tag == TAG_STRING:
            return self.string()
        if tag == TAG_LIST:
            item_tag = self.u8()
            n = self.be(">i", 4)
            return [self.payload(item_tag) for _ in range(n)]
        if tag == TAG_COMPOUND:
            out = {}
            while True:
                t = self.u8()
                if t == TAG_END:
                    return out
                name = self.string()
                out[name] = self.payload(t)
        if tag == TAG_INT_ARRAY:
            n = self.be(">i", 4)
            a = np.frombuffer(self.buf, ">i4", n, self.pos).astype(np.int32)
            self.pos += 4 * n
            return a
        if tag == TAG_LONG_ARRAY:
            n = self.be(">i", 4)
            a = np.frombuffer(self.buf, ">i8", n, self.pos).astype(np.int64)
            self.pos += 8 * n
            return a
        raise ValueError(f"unknown NBT tag {tag}")


def read_nbt(buf: bytes) -> dict:
    """Parse a root compound; returns its dict (root name ignored)."""
    r = _Reader(buf)
    tag = r.u8()
    assert tag == TAG_COMPOUND, f"root must be a compound, got {tag}"
    r.string()  # root name
    return r.payload(TAG_COMPOUND)


# ---------------- writer (test fixtures) ----------------


def _w_string(out, s: str):
    b = s.encode("utf-8")
    out += struct.pack(">H", len(b)) + b
    return out


def _tag_of(value):
    if isinstance(value, bool):
        return TAG_BYTE
    if isinstance(value, int):
        return TAG_INT if -(2**31) <= value < 2**31 else TAG_LONG
    if isinstance(value, float):
        return TAG_DOUBLE
    if isinstance(value, str):
        return TAG_STRING
    if isinstance(value, dict):
        return TAG_COMPOUND
    if isinstance(value, list):
        return TAG_LIST
    if isinstance(value, np.ndarray):
        if value.dtype == np.int64:
            return TAG_LONG_ARRAY
        if value.dtype == np.int32:
            return TAG_INT_ARRAY
        if value.dtype == np.int8:
            return TAG_BYTE_ARRAY
    raise TypeError(f"cannot encode {type(value)}")


def _w_payload(out: bytearray, tag, value):
    if tag == TAG_BYTE:
        out += struct.pack(">b", int(value))
    elif tag == TAG_INT:
        out += struct.pack(">i", int(value))
    elif tag == TAG_LONG:
        out += struct.pack(">q", int(value))
    elif tag == TAG_DOUBLE:
        out += struct.pack(">d", float(value))
    elif tag == TAG_STRING:
        _w_string(out, value)
    elif tag == TAG_COMPOUND:
        for k, v in value.items():
            t = _tag_of(v)
            out += bytes([t])
            _w_string(out, k)
            _w_payload(out, t, v)
        out += bytes([TAG_END])
    elif tag == TAG_LIST:
        item_tag = _tag_of(value[0]) if value else TAG_END
        out += bytes([item_tag])
        out += struct.pack(">i", len(value))
        for v in value:
            _w_payload(out, item_tag, v)
    elif tag == TAG_LONG_ARRAY:
        out += struct.pack(">i", len(value))
        out += np.asarray(value, ">i8").tobytes()
    elif tag == TAG_INT_ARRAY:
        out += struct.pack(">i", len(value))
        out += np.asarray(value, ">i4").tobytes()
    elif tag == TAG_BYTE_ARRAY:
        out += struct.pack(">i", len(value))
        out += np.asarray(value, np.int8).tobytes()
    else:
        raise TypeError(f"cannot write tag {tag}")
    return out


def write_nbt(root: dict, root_name: str = "") -> bytes:
    out = bytearray([TAG_COMPOUND])
    _w_string(out, root_name)
    _w_payload(out, TAG_COMPOUND, root)
    return bytes(out)
