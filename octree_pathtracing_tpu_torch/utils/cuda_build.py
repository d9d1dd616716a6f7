"""Build a CUDA source of ``csrc/`` into a shared library and load it.

``nvcc`` compiles a ``.cu`` file with a plain C interface for Hopper
(``sm_90a``) into ``build/kernels/``; ``ctypes`` loads it.  The library's
name carries a hash of the source and the flags, so an edited kernel is
rebuilt and an unchanged one is loaded as built (the hash covers the
headers of ``csrc/`` too).  Nothing is compiled at
import time: each kernel's wrapper builds and loads its library once, at
its first launch.  :func:`on_current_stream` is the wrappers' launch path.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

from .. import BUILD_DIR

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
KERNEL_DIR = os.path.join(BUILD_DIR, "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: CUDA kernels build only where the CUDA toolkit is installed")


def load_library(name: str, extra_flags: tuple = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (if not built yet) and load it.  The
    library's ``build_info`` is {"path", "seconds" (0.0 when it was already
    built), "log" (nvcc and ptxas output)}."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    flags = ARCH_FLAGS + BASE_FLAGS + list(extra_flags)
    h = hashlib.sha256(" ".join(flags).encode())
    # the source and every header of csrc/ it may include
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    out = os.path.join(KERNEL_DIR, f"lib{name}_{digest}.so")
    info = {"path": out, "seconds": 0.0, "log": ""}
    if not os.path.exists(out):
        os.makedirs(KERNEL_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, src], capture_output=True, text=True, timeout=600
        )
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{info['log']}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(out)
    lib.build_info = info
    return lib


def on_current_stream(fn, device_index: int, *args):
    """``fn(*args, stream)``, with ``stream`` PyTorch's current stream on
    card ``device_index`` (the capture stream while a CUDA graph captures).
    A C entry point launches on the current card, so the device guard is
    entered only when ``device_index`` is not the current card.  Returns
    what ``fn`` returns."""
    # the raw handle, as PyTorch's own kernel launchers take it: building a
    # torch.cuda.Stream for its .cuda_stream costs microseconds per launch
    stream = torch._C._cuda_getCurrentRawStream(device_index)
    if device_index == torch._C._cuda_getDevice():  # torch.cuda.current_device() less its lazy-init check
        return fn(*args, stream)
    with torch.cuda.device(device_index):
        return fn(*args, stream)
