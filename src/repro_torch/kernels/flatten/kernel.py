"""K6/K7 launchers: CUDA compaction and segmented gather (``csrc/flatten.cu``).

K6 replaces ``repro/kernels/flatten/kernel.py::compact_blocks_pallas``, K7
``::segmented_gather_pallas``.  Both move bits: 2- and 4-byte scalar items.
K7 with ``instrument=True`` launches its counting instantiation (K15) and
also returns the ``(NSLOTS,)`` int32 counter block (``obs/device.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import indexing
from repro_torch.kernels import _build, common
from repro_torch.obs import device as obs_device

__all__ = ["compact_blocks_cuda", "segmented_gather_cuda", "ITEM_DTYPES", "MAX_GATHER_BLOCKS"]

ITEM_DTYPES = (torch.float32, torch.int32, torch.bfloat16, torch.float16)
MAX_LEVELS = 32
# K7 stages starts/ends (8 bytes per block) in at most 227 KB of shared memory;
# the counting instantiation keeps 64 bytes of it for ctr_accum.
MAX_GATHER_BLOCKS = 227 * 1024 // 8
MAX_GATHER_BLOCKS_COUNTED = (227 * 1024 - 64) // 8

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _lib():
    lib = _build.library("flatten")
    lib.rt_compact_blocks.argtypes = [_c, ctypes.c_int, _c, _i64, _i64, ctypes.c_int, _c]
    lib.rt_compact_blocks.restype = ctypes.c_int
    lib.rt_segmented_gather.argtypes = [_c, _c, _c, _c, _i64, _i64, ctypes.c_int, _c, _c]
    lib.rt_segmented_gather.restype = ctypes.c_int
    return lib


def compact_blocks_cuda(levels: tuple[torch.Tensor, ...], b0: int) -> torch.Tensor:
    """Launch K6: level b ``(nblocks, B0·2^b)`` → ``(nblocks, cap)``."""
    dev = levels[0].device
    if dev.type != "cuda":
        raise ValueError(f"compact_blocks_cuda: tensors on {dev}, expected cuda")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"compact_blocks: {len(levels)} levels, supported 1..{MAX_LEVELS}")
    nblocks = levels[0].shape[0]
    for b, (level, width) in enumerate(zip(levels, indexing.bucket_sizes(b0, len(levels)))):
        common.check_tensor(level, f"compact_blocks level {b}", device=dev,
                            dtypes=(levels[0].dtype,), shape=(nblocks, width))
    if levels[0].dtype not in ITEM_DTYPES:
        raise TypeError(f"compact_blocks: dtype {levels[0].dtype} not in {ITEM_DTYPES}")
    cap = indexing.capacity(b0, len(levels))
    out = torch.empty((nblocks, cap), dtype=levels[0].dtype, device=dev)
    if nblocks == 0:
        return out
    lib = _lib()
    ptrs = (ctypes.c_void_p * len(levels))(*(lv.data_ptr() for lv in levels))
    with torch.cuda.device(dev):
        rc = lib.rt_compact_blocks(
            ctypes.cast(ptrs, _c), len(levels), out.data_ptr(), nblocks, b0,
            out.element_size(), common.stream_of(dev),
        )
    common.check_status(rc, lib, "compact_blocks")
    common.count_launch("compact_blocks")
    return out


def segmented_gather_cuda(
    compact: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor, *, instrument: bool = False
):
    """Launch K7: ``(nblocks, cap)`` plane + int32 starts/ends → ``(nblocks·cap,)``,
    and with ``instrument`` the counter block (launch, rows touched)."""
    dev = compact.device
    if dev.type != "cuda":
        raise ValueError(f"segmented_gather_cuda: tensors on {dev}, expected cuda")
    common.check_tensor(compact, "segmented_gather compact", device=dev, dtypes=ITEM_DTYPES)
    if compact.ndim != 2:
        raise ValueError(f"segmented_gather compact: expected (nblocks, cap), got {tuple(compact.shape)}")
    nblocks, cap = compact.shape
    limit = MAX_GATHER_BLOCKS_COUNTED if instrument else MAX_GATHER_BLOCKS
    if nblocks > limit:
        raise ValueError(f"segmented_gather: {nblocks} blocks, supported ≤ {limit}")
    for name, t in (("starts", starts), ("ends", ends)):
        common.check_tensor(t, f"segmented_gather {name}", device=dev,
                            dtypes=(torch.int32,), shape=(nblocks,))
    out = torch.empty((nblocks * cap,), dtype=compact.dtype, device=dev)
    block = obs_device.new_block(dev) if instrument else None
    if nblocks == 0 or cap == 0:
        return out if block is None else (out, block)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.rt_segmented_gather(
            compact.data_ptr(), starts.data_ptr(), ends.data_ptr(), out.data_ptr(),
            nblocks, cap, compact.element_size(),
            block.data_ptr() if block is not None else None, common.stream_of(dev),
        )
    common.check_status(rc, lib, "segmented_gather")
    common.count_launch("segmented_gather")
    if block is None:
        return out
    common.count_launch("counter_plane")
    return out, block
