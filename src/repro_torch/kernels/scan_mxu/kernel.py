"""K2 launcher: the tensor-core row scan (``csrc/scan_mxu.cu``).

Replaces ``repro/kernels/scan_mxu/kernel.py::row_scan_pallas``.  int32 is
exact (byte planes through u8 tensor-core products, bitwise equal to
``torch.cumsum``); f32 goes through split TF32.  Three launches per call
(segment totals, carries, scan), counted as one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common

__all__ = ["row_scan_mxu_cuda", "DTYPES"]

DTYPES = {torch.int32: 0, torch.float32: 1}

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _lib():
    lib = _build.library("scan_mxu")
    lib.rt_row_scan_mxu.argtypes = [_c, _c, _c, _c, ctypes.c_int, _i64, _i64, _c]
    lib.rt_row_scan_mxu.restype = ctypes.c_int
    lib.rt_scan_mxu_segments.argtypes = [_i64]
    lib.rt_scan_mxu_segments.restype = _i64
    return lib


def row_scan_mxu_cuda(x: torch.Tensor) -> torch.Tensor:
    """Inclusive per-row prefix sum of an int32 or f32 ``(rows, cols)`` CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"row_scan_mxu_cuda: tensor on {x.device}, expected cuda")
    common.check_tensor(x, "row_scan_mxu x", device=x.device, dtypes=tuple(DTYPES))
    if x.ndim != 2:
        raise ValueError(f"row_scan_mxu x: expected (rows, cols), got {tuple(x.shape)}")
    out = torch.empty_like(x)
    rows, cols = x.shape
    if rows == 0 or cols == 0:
        return out
    lib = _lib()
    nseg = lib.rt_scan_mxu_segments(cols)
    scratch = torch.empty((2, nseg * rows), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.rt_row_scan_mxu(
            x.data_ptr(), out.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
            DTYPES[x.dtype], rows, cols, common.stream_of(x.device),
        )
    common.check_status(rc, lib, "row_scan_mxu")
    common.count_launch("row_scan_mxu")
    return out
