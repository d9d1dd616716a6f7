"""Row gather: kernel P1 (CUDA, ``csrc/gather.cu``), its plain-torch twins,
and the wrappers that pick between them by device.

Port of the Pallas ``k_smem_loop`` probe of ``tools/profile_pallas.py``
(:67, called at :75): ``out[i] = table[idx[i]]`` for a ``(N, W)`` table of
32-bit rows (W = 8 in the probe and on the main path).  :func:`row_gather`
gathers from one table; :func:`row_gather_pair` gathers the same rows of
two tables of one shape in one launch, as the emitter pick
(``models/emitters._spatial_pick``) does with each lane's supercell row of
``grid_idx`` (int32) and ``grid_w`` (float32); the rows are ``min(8, E)``
wide for a table of E emitters.  An index in ``[-N, -1]`` wraps to
``index + N`` as jnp indexing does; then indices are clipped to
``[0, N - 1]`` as XLA clips a gather's.  The kernel copies 32-bit words
whatever their type,
so kernel and twins agree bit for bit.  Nothing here carries a gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.cuda_build import on_current_stream

_WORD_TYPES = (torch.int32, torch.float32)
_INDEX_TYPES = (torch.int32, torch.int64)  # the kernel reads both as they are


def _check(tables, idx):
    for table in tables:
        if table.dim() != 2 or table.dtype not in _WORD_TYPES:
            raise ValueError("row_gather: table must be (N, W) int32 or float32")
        if table.shape[0] == 0 or table.shape[1] == 0:
            raise ValueError("row_gather: empty table")
        if table.device != tables[0].device:
            raise ValueError("row_gather: tables and idx must be on one device")
    if tables[-1].shape != tables[0].shape:
        raise ValueError("row_gather_pair: the two tables must have one shape")
    if idx.dim() != 1 or idx.dtype.is_floating_point or idx.dtype.is_complex or idx.dtype == torch.bool:
        raise ValueError("row_gather: idx must be a (B,) integer tensor")
    if idx.device != tables[0].device:
        raise ValueError("row_gather: tables and idx must be on one device")


def _clipped(idx, n_rows):
    """``idx`` as rows: [-N, -1] wrapped by N, then clipped to the table."""
    i = idx.long()
    return torch.where(i < 0, i + n_rows, i).clamp(0, n_rows - 1)


def row_gather_reference(table, idx):
    """Plain-torch twin of kernel P1 (any device): ``table[clip(wrap(idx))]``."""
    _check((table,), idx)
    return table.index_select(0, _clipped(idx, table.shape[0]))


def row_gather_pair_reference(a, b, idx):
    """Plain-torch twin of kernel P1 on two tables of one shape (any
    device): ``(a[clip(idx)], b[clip(idx)])``."""
    _check((a, b), idx)
    i = _clipped(idx, a.shape[0])
    return a.index_select(0, i), b.index_select(0, i)


@functools.cache
def _library():
    """P1's shared library, built at first use."""
    from ..utils.cuda_build import load_library

    lib = load_library("gather")
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.row_gather.argtypes = [vp, vp, cll, ci, ci, vp, ci, cll, vp, vp, vp]
    lib.row_gather.restype = ci
    lib.row_gather_error_string.argtypes = [ci]
    lib.row_gather_error_string.restype = ctypes.c_char_p
    return lib


def _fits_kernel(a, b, idx, dev: int) -> bool:
    """What the kernel takes as it is, in plain attribute tests."""
    return (a.dtype in _WORD_TYPES and a.dim() == 2 and a.numel() > 0 and a.is_contiguous()
            and idx.dtype in _INDEX_TYPES and idx.dim() == 1 and idx.is_contiguous()
            and idx.get_device() == dev
            and (b is None or (b.dtype in _WORD_TYPES and b.shape == a.shape and b.is_contiguous()
                               and b.get_device() == dev)))


def _gather_cuda(a, b, idx):
    """Kernel P1 on the card: ``a[idx]`` and, unless ``b`` is None,
    ``b[idx]`` in the same launch."""
    dev = a.get_device()
    if not _fits_kernel(a, b, idx, dev):
        _check((a,) if b is None else (a, b), idx)  # raises on what no path takes
        if not (a.is_contiguous() and (b is None or b.is_contiguous())):
            raise ValueError("row_gather: tables must be contiguous")
        idx = idx.to(torch.int64).contiguous()  # another integer type, or strided
    n, width = idx.shape[0], a.shape[1]
    out_a = a.new_empty((n, width))
    out_b = None if b is None else b.new_empty((n, width))
    if n == 0:  # an empty gather launches nothing
        return out_a, out_b
    pa, oa = a.data_ptr(), out_a.data_ptr()
    pb, ob = (0, 0) if b is None else (b.data_ptr(), out_b.data_ptr())
    # 16-byte pieces where the rows and pointers allow them (a fresh
    # allocation is 16-byte aligned; a table that is a view may not be)
    vec4 = width % 4 == 0 and (pa | oa | pb | ob) % 16 == 0
    lib = _library()
    rc = on_current_stream(lib.row_gather, dev, pa, pb, a.shape[0], width, vec4, idx.data_ptr(),
                           idx.dtype == torch.int64, n, oa, ob)
    if rc != 0:
        raise RuntimeError(f"row_gather launch failed: {lib.row_gather_error_string(rc).decode()}")
    row_gather.launches += 1
    return out_a, out_b


def row_gather(table, idx):
    """``(B, W)`` rows ``table[idx]`` (negative indices wrapped once, then
    clipped to the table).

    CUDA tensors launch kernel P1 (``csrc/gather.cu``) and count the launch
    in ``row_gather.launches``; CPU tensors run :func:`row_gather_reference`.
    Any other device raises."""
    if table.is_cuda:
        return _gather_cuda(table, None, idx)[0]
    if table.device.type == "cpu":
        return row_gather_reference(table, idx)
    raise ValueError(f"row_gather: unsupported device {table.device}")


def row_gather_pair(a, b, idx):
    """``(a[idx], b[idx])`` for two tables of one ``(N, W)`` shape (each
    int32 or float32), with one read of each index (clipped to the tables).

    CUDA tensors launch kernel P1 once for both tables and count it in
    ``row_gather.launches`` (P1's one counter); CPU tensors run
    :func:`row_gather_pair_reference`.  Any other device raises."""
    if a.is_cuda:
        return _gather_cuda(a, b, idx)
    if a.device.type == "cpu":
        return row_gather_pair_reference(a, b, idx)
    raise ValueError(f"row_gather_pair: unsupported device {a.device}")


row_gather.launches = 0
