"""ctypes binding and on-demand build of the C++ region parser (copy of
``octree_pathtracing_tpu/models/native.py``).

The shared library is compiled from ``csrc/mca_parser.cc`` with the system
g++ and zlib at first use, into ``build/native/`` (its name carries a hash
of the source, so an edited parser is rebuilt).  Where the compiler or zlib
is missing the build raises, and ``mca.py`` falls back to its numpy parser.
This is host code: nothing of it runs on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading

import numpy as np

from .. import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "mca_parser.cc")
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def _build() -> str:
    """The library's path, compiled first where it is not built yet."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, "native", f"libmca_parser_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp, "-lz"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC}:\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


ABI_VERSION = 2  # protocol v2: per-section biome palette + cell tail


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.native_abi_version.restype = ctypes.c_int64
            if lib.native_abi_version() != ABI_VERSION:
                raise RuntimeError(
                    f"libmca_parser abi {lib.native_abi_version()} != {ABI_VERSION}"
                )
            lib.parse_region.restype = ctypes.c_int64
            lib.parse_region.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int64,
                ctypes.c_char_p,
                ctypes.c_int64,
            ]
            _lib = lib
    return _lib


def parse_region_native(buf: bytes):
    """Parse an .mca blob with the C++ library; returns [Section] (mca.Section)."""
    from .mca import Section

    lib = get_lib()
    cap = max(len(buf) * 4, 1 << 20)
    out = ctypes.create_string_buffer(cap)
    n = lib.parse_region(buf, len(buf), out, cap)
    if n < 0:
        if n == -1:
            raise ValueError("malformed region file")
        cap = -n
        out = ctypes.create_string_buffer(cap)
        n = lib.parse_region(buf, len(buf), out, cap)
        if n < 0:
            raise ValueError("native parse failed")
    blob = out.raw
    sections = []
    pos = 0
    for _ in range(n):
        cx, cz, y_pos, pcount = struct.unpack_from("<iiii", blob, pos)
        pos += 16
        palette = []
        for _ in range(pcount):
            (ln,) = struct.unpack_from("<H", blob, pos)
            pos += 2
            palette.append(blob[pos : pos + ln].decode("utf-8", "replace"))
            pos += ln
        indices = np.frombuffer(blob, "<u2", 4096, pos).copy()
        pos += 8192
        (bcount,) = struct.unpack_from("<i", blob, pos)
        pos += 4
        b_pal = None
        b_idx = None
        if bcount > 0:
            b_pal = []
            for _ in range(bcount):
                (ln,) = struct.unpack_from("<H", blob, pos)
                pos += 2
                b_pal.append(blob[pos : pos + ln].decode("utf-8", "replace"))
                pos += ln
            b_idx = np.frombuffer(blob, "<u2", 64, pos).copy()
            pos += 128
        sections.append(
            Section(
                chunk_x=cx,
                chunk_z=cz,
                y_pos=y_pos,
                palette=palette,
                indices=indices,
                biome_palette=b_pal,
                biome_indices=b_idx,
            )
        )
    return sections
