"""K1 launcher: the CUDA row scan (``csrc/scan_tile.cu``).

Replaces ``repro/kernels/scan_tile/kernel.py::row_scan_pallas``.  One
thread block per row; int32 only, since ``insertion_offsets`` feeds it int32
masks.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common

__all__ = ["row_scan_cuda"]

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _lib():
    lib = _build.library("scan_tile")
    lib.rt_row_scan_i32.argtypes = [_c, _c, _i64, _i64, _c]
    lib.rt_row_scan_i32.restype = ctypes.c_int
    return lib


def row_scan_cuda(x: torch.Tensor) -> torch.Tensor:
    """Inclusive per-row prefix sum of an int32 ``(rows, cols)`` CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"row_scan_cuda: tensor on {x.device}, expected cuda")
    common.check_tensor(x, "row_scan x", device=x.device, dtypes=(torch.int32,))
    if x.ndim != 2:
        raise ValueError(f"row_scan x: expected (rows, cols), got {tuple(x.shape)}")
    out = torch.empty_like(x)
    rows, cols = x.shape
    if rows == 0 or cols == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.rt_row_scan_i32(
            x.data_ptr(), out.data_ptr(), rows, cols, common.stream_of(x.device)
        )
    common.check_status(rc, lib, "row_scan")
    common.count_launch("row_scan")
    return out
