"""K3 launcher: the CUDA fused push-back (``csrc/push_back.cu``).

Replaces ``repro/kernels/push_back/kernel.py::push_back_pallas``.  The level
tensors are written in place — the counterpart of the reference's
``input_output_aliases`` on the levels.  Items of any shape are carried as
``item_bytes`` of raw bits per lane.  The C side takes a [group][level]
pointer table; this slice launches one group (the multi-group KV-cache
append comes with serving).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import indexing
from repro_torch.kernels import _build, common

__all__ = ["push_back_cuda", "PAYLOAD_DTYPES"]

# Payloads are copied as 2- or 4-byte words.
PAYLOAD_DTYPES = (torch.float32, torch.int32, torch.bfloat16, torch.float16)
MAX_LEVELS = 32

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _lib():
    lib = _build.library("push_back")
    lib.rt_push_back.argtypes = [
        _c, _c, _c, ctypes.c_int, ctypes.c_int,  # tables, ngroups, nlevels
        _c, _c, _c, _c,  # mask, sizes, pos_out, new_sizes
        _i64, _i64, _i64, _c,  # nblocks, m, b0, stream
    ]
    lib.rt_push_back.restype = ctypes.c_int
    return lib


def push_back_cuda(
    levels: tuple[torch.Tensor, ...],
    sizes: torch.Tensor,
    b0: int,
    elems: torch.Tensor,
    mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on one payload group → (new sizes, positions).

    ``levels``: level b ``(nblocks, B0·2^b, *item)``, written in place;
    ``sizes``: ``(nblocks,)`` int32; ``elems``: ``(nblocks, m, *item)``;
    ``mask``: ``(nblocks, m)`` bool.  All contiguous, on one CUDA device.
    """
    dev = elems.device
    if dev.type != "cuda":
        raise ValueError(f"push_back_cuda: tensors on {dev}, expected cuda")
    if elems.ndim < 2:
        raise ValueError(f"push_back elems: expected (nblocks, m, *item), got {tuple(elems.shape)}")
    nblocks, m = elems.shape[:2]
    item = tuple(elems.shape[2:])
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"push_back: {len(levels)} levels, supported 1..{MAX_LEVELS}")
    common.check_tensor(elems, "push_back elems", device=dev, dtypes=PAYLOAD_DTYPES)
    common.check_tensor(mask, "push_back mask", device=dev, dtypes=(torch.bool,),
                        shape=(nblocks, m))
    common.check_tensor(sizes, "push_back sizes", device=dev, dtypes=(torch.int32,),
                        shape=(nblocks,))
    for b, (level, width) in enumerate(zip(levels, indexing.bucket_sizes(b0, len(levels)))):
        common.check_tensor(level, f"push_back level {b}", device=dev, dtypes=(elems.dtype,),
                            shape=(nblocks, width, *item))
    pos = torch.empty((nblocks, m), dtype=torch.int32, device=dev)
    new_sizes = torch.empty_like(sizes)
    if nblocks == 0 or m == 0:
        new_sizes.copy_(sizes)
        return new_sizes, pos
    item_bytes = elems.element_size()
    for d in item:
        item_bytes *= d
    lib = _lib()
    level_ptrs = (ctypes.c_void_p * len(levels))(*(lv.data_ptr() for lv in levels))
    elem_ptrs = (ctypes.c_void_p * 1)(elems.data_ptr())
    nbytes = (ctypes.c_int64 * 1)(item_bytes)
    with torch.cuda.device(dev):
        rc = lib.rt_push_back(
            ctypes.cast(level_ptrs, _c), ctypes.cast(elem_ptrs, _c),
            ctypes.cast(nbytes, _c), 1, len(levels),
            mask.data_ptr(), sizes.data_ptr(), pos.data_ptr(), new_sizes.data_ptr(),
            nblocks, m, b0, common.stream_of(dev),
        )
    common.check_status(rc, lib, "push_back")
    common.count_launch("push_back")
    return new_sizes, pos
