"""Row gather: kernel P1 (CUDA, ``csrc/gather.cu``), its plain-torch twin,
and the wrapper that picks between them by device.

Port of the Pallas ``k_smem_loop`` probe of ``tools/profile_pallas.py``
(:67, called at :75): ``out[i] = table[idx[i]]`` for a ``(N, W)`` table of
32-bit rows (W = 8 in the probe and on the main path).  The emitter pick
(``models/emitters._spatial_pick``) gathers each lane's supercell row of
``grid_idx`` (int32) and ``grid_w`` (float32) through it; the rows are
``min(8, E)`` wide for a table of E emitters.  Indices are clipped to
``[0, N - 1]`` as XLA clips a gather's.  A float32 table goes through an
int32 view, so kernel and twin copy bits and agree bit for bit.  Nothing
here carries a gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def _check(table, idx):
    if table.dim() != 2 or table.dtype not in (torch.int32, torch.float32):
        raise ValueError("row_gather: table must be (N, W) int32 or float32")
    if table.shape[0] == 0 or table.shape[1] == 0:
        raise ValueError("row_gather: empty table")
    if idx.dim() != 1 or idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise ValueError("row_gather: idx must be a (B,) integer tensor")
    if idx.device != table.device:
        raise ValueError("row_gather: table and idx must be on one device")


def row_gather_reference(table, idx):
    """Plain-torch twin of kernel P1 (any device): ``table[clip(idx)]``."""
    _check(table, idx)
    return table.index_select(0, idx.long().clamp(0, table.shape[0] - 1))


@functools.cache
def _library():
    """P1's shared library, built at first use."""
    from ..utils.cuda_build import load_library

    lib = load_library("gather")
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.row_gather.argtypes = [vp, cll, ci, ci, vp, cll, vp, vp]
    lib.row_gather.restype = ci
    lib.row_gather_error_string.argtypes = [ci]
    lib.row_gather_error_string.restype = ctypes.c_char_p
    return lib


def _row_gather_cuda(table, idx):
    if not table.is_contiguous():
        raise ValueError("row_gather: table must be contiguous")
    words = table.view(torch.int32)
    width = table.shape[1]
    idx32 = idx.to(torch.int32).contiguous()
    out = torch.empty((idx.shape[0], width), dtype=torch.int32, device=table.device)
    if idx.shape[0] == 0:  # an empty gather launches nothing
        return out.view(table.dtype)
    # 16-byte pieces where the rows allow them (torch.empty is 16-byte aligned)
    vec4 = width % 4 == 0 and words.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    lib = _library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.row_gather(words.data_ptr(), table.shape[0], width, int(vec4), idx32.data_ptr(),
                            idx.shape[0], out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"row_gather launch failed: {lib.row_gather_error_string(rc).decode()}")
    row_gather.launches += 1
    return out.view(table.dtype)


def row_gather(table, idx):
    """``(B, W)`` rows ``table[idx]`` (indices clipped to the table).

    CUDA tensors launch kernel P1 (``csrc/gather.cu``) and count the launch
    in ``row_gather.launches``; CPU tensors run :func:`row_gather_reference`.
    Any other device raises."""
    _check(table, idx)
    if table.device.type == "cuda":
        return _row_gather_cuda(table, idx)
    if table.device.type == "cpu":
        return row_gather_reference(table, idx)
    raise ValueError(f"row_gather: unsupported device {table.device}")


row_gather.launches = 0
