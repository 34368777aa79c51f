"""K5a/K5b launchers: the CUDA scatter-add dispatch and the gather combine
(``csrc/dispatch.cu``).

K5a replaces ``repro/kernels/dispatch_mxu/kernel.py::dispatch_pallas`` and
K5b ``::combine_pallas``: the reference's one-hot matrix products become a
zero fill plus an ``atomicAdd`` scatter and a row gather.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common

__all__ = ["dispatch_cuda", "combine_cuda", "DISPATCH_DTYPES"]

DISPATCH_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _lib():
    lib = _build.library("dispatch")
    lib.rt_dispatch.argtypes = [_c, _c, _c, ctypes.c_int, _i64, _i64, _i64, _c]
    lib.rt_dispatch.restype = ctypes.c_int
    lib.rt_combine.argtypes = [_c, _c, _c, _i64, _i64, _i64, ctypes.c_int, _c]
    lib.rt_combine.restype = ctypes.c_int
    return lib


def _check_pos(pos: torch.Tensor, n: int, dev: torch.device, what: str) -> None:
    common.check_tensor(pos, f"{what} pos", device=dev, dtypes=(torch.int32,), shape=(n,))


def dispatch_cuda(x: torch.Tensor, pos: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Launch K5a: ``x (T, D)``, int32 ``pos (T,)`` → ``(n_slots, D)``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"dispatch_cuda: tensors on {dev}, expected cuda")
    common.check_tensor(x, "dispatch x", device=dev, dtypes=tuple(DISPATCH_DTYPES))
    if x.ndim != 2:
        raise ValueError(f"dispatch x: expected (T, D), got {tuple(x.shape)}")
    T, D = x.shape
    _check_pos(pos, T, dev, "dispatch")
    if n_slots < 0:
        raise ValueError(f"dispatch: n_slots {n_slots} < 0")
    out = torch.empty((n_slots, D), dtype=x.dtype, device=dev)
    if n_slots * D == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.rt_dispatch(x.data_ptr(), pos.data_ptr(), out.data_ptr(),
                             DISPATCH_DTYPES[x.dtype], T, D, n_slots, common.stream_of(dev))
    common.check_status(rc, lib, "dispatch")
    common.count_launch("dispatch")
    return out


def combine_cuda(buf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Launch K5b: ``buf (S, *item)``, int32 ``pos (T,)`` → ``(T, *item)``."""
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"combine_cuda: tensors on {dev}, expected cuda")
    common.check_tensor(buf, "combine buf", device=dev)
    if buf.ndim < 1 or buf.shape[0] < 1:
        raise ValueError(f"combine buf: expected (S >= 1, ...), got {tuple(buf.shape)}")
    T = pos.shape[0] if pos.ndim == 1 else -1
    _check_pos(pos, T, dev, "combine")
    out = torch.empty((T, *buf.shape[1:]), dtype=buf.dtype, device=dev)
    row_bytes = buf[0].numel() * buf.element_size()
    if T * row_bytes == 0:
        return out
    lib = _lib()
    unit = next(u for u in (16, 8, 4, 2, 1)
                if row_bytes % u == 0 and buf.data_ptr() % u == 0 and out.data_ptr() % u == 0)
    with torch.cuda.device(dev):
        rc = lib.rt_combine(buf.data_ptr(), pos.data_ptr(), out.data_ptr(), T, row_bytes,
                            buf.shape[0], unit, common.stream_of(dev))
    common.check_status(rc, lib, "combine")
    common.count_launch("combine")
    return out
