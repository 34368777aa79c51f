"""K3 launcher: the CUDA fused push-back (``csrc/push_back.cu``).

Replaces ``repro/kernels/push_back/kernel.py::push_back_pallas``.  The level
tensors are written in place — the counterpart of the reference's
``input_output_aliases`` on the levels.  Items of any shape are carried as
``item_bytes`` of raw bits per lane.  The C side takes a [group][level]
pointer table: one launch writes up to four payload groups that share the
mask (the KV cache's k and v), each with its own item size.

``instrument=True`` launches the counting instantiation (K15) and returns
its ``(NSLOTS,)`` int32 counter block (``obs/device.py``) as a third output.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import indexing
from repro_torch.kernels import _build, common
from repro_torch.obs import device as obs_device

__all__ = ["push_back_cuda", "push_back_cuda_multi", "PAYLOAD_DTYPES"]

# Payloads are copied as 2- or 4-byte words.
PAYLOAD_DTYPES = (torch.float32, torch.int32, torch.bfloat16, torch.float16)
MAX_LEVELS = 32
MAX_GROUPS = 4  # csrc/push_back.cu kMaxGroups

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _lib():
    lib = _build.library("push_back")
    lib.rt_push_back.argtypes = [
        _c, _c, _c, ctypes.c_int, ctypes.c_int,  # tables, ngroups, nlevels
        _c, _c, _c, _c,  # mask, sizes, pos_out, new_sizes
        _i64, _i64, _i64, _c, _c,  # nblocks, m, b0, ctr, stream
    ]
    lib.rt_push_back.restype = ctypes.c_int
    return lib


def push_back_cuda(
    levels: tuple[torch.Tensor, ...],
    sizes: torch.Tensor,
    b0: int,
    elems: torch.Tensor,
    mask: torch.Tensor,
    *,
    instrument: bool = False,
) -> tuple:
    """Launch K3 on one payload group → (new sizes, positions[, counter block]).

    ``levels``: level b ``(nblocks, B0·2^b, *item)``, written in place;
    ``sizes``: ``(nblocks,)`` int32; ``elems``: ``(nblocks, m, *item)``;
    ``mask``: ``(nblocks, m)`` bool.  All contiguous, on one CUDA device.
    """
    return push_back_cuda_multi((levels,), sizes, b0, (elems,), mask, instrument=instrument)


def push_back_cuda_multi(
    level_groups: tuple[tuple[torch.Tensor, ...], ...],
    sizes: torch.Tensor,
    b0: int,
    elem_groups: tuple[torch.Tensor, ...],
    mask: torch.Tensor,
    *,
    instrument: bool = False,
) -> tuple:
    """Launch K3 once over ``len(level_groups)`` payload groups → (new sizes,
    positions), and with ``instrument`` the counter block.

    Every group shares the one offset scan and the one mask: group g's wave
    ``elem_groups[g]`` ``(nblocks, m, *item_g)`` lands in its own levels
    ``level_groups[g]`` (level b ``(nblocks, B0·2^b, *item_g)``, written in
    place) at the same positions — the KV cache's k and v in one launch.
    """
    if not 1 <= len(level_groups) <= MAX_GROUPS or len(elem_groups) != len(level_groups):
        raise ValueError(f"push_back: {len(level_groups)} level groups and {len(elem_groups)} "
                         f"payload groups, supported 1..{MAX_GROUPS} of each, equal counts")
    elems0 = elem_groups[0]
    dev = elems0.device
    if dev.type != "cuda":
        raise ValueError(f"push_back_cuda: tensors on {dev}, expected cuda")
    if elems0.ndim < 2:
        raise ValueError(f"push_back elems: expected (nblocks, m, *item), got {tuple(elems0.shape)}")
    nblocks, m = elems0.shape[:2]
    nlevels = len(level_groups[0])
    if not 1 <= nlevels <= MAX_LEVELS:
        raise ValueError(f"push_back: {nlevels} levels, supported 1..{MAX_LEVELS}")
    common.check_tensor(mask, "push_back mask", device=dev, dtypes=(torch.bool,),
                        shape=(nblocks, m))
    common.check_tensor(sizes, "push_back sizes", device=dev, dtypes=(torch.int32,),
                        shape=(nblocks,))
    widths = indexing.bucket_sizes(b0, nlevels)
    item_bytes = []
    for g, (levels, elems) in enumerate(zip(level_groups, elem_groups)):
        common.check_tensor(elems, f"push_back elems[{g}]", device=dev, dtypes=PAYLOAD_DTYPES)
        if tuple(elems.shape[:2]) != (nblocks, m):
            raise ValueError(f"push_back elems[{g}]: shape {tuple(elems.shape)}, expected "
                             f"({nblocks}, {m}, *item)")
        if len(levels) != nlevels:
            raise ValueError(f"push_back group {g}: {len(levels)} levels, expected {nlevels}")
        item = tuple(elems.shape[2:])
        for b, (level, width) in enumerate(zip(levels, widths)):
            common.check_tensor(level, f"push_back group {g} level {b}", device=dev,
                                dtypes=(elems.dtype,), shape=(nblocks, width, *item))
        nbytes = elems.element_size()
        for d in item:
            nbytes *= d
        item_bytes.append(nbytes)
    pos = torch.empty((nblocks, m), dtype=torch.int32, device=dev)
    new_sizes = torch.empty_like(sizes)
    block = obs_device.new_block(dev) if instrument else None
    if nblocks == 0 or m == 0:
        new_sizes.copy_(sizes)
        return (new_sizes, pos) if block is None else (new_sizes, pos, block)
    lib = _lib()
    ngroups = len(level_groups)
    level_ptrs = (ctypes.c_void_p * (ngroups * nlevels))(
        *(lv.data_ptr() for levels in level_groups for lv in levels))
    elem_ptrs = (ctypes.c_void_p * ngroups)(*(e.data_ptr() for e in elem_groups))
    nbytes = (ctypes.c_int64 * ngroups)(*item_bytes)
    with torch.cuda.device(dev):
        rc = lib.rt_push_back(
            ctypes.cast(level_ptrs, _c), ctypes.cast(elem_ptrs, _c),
            ctypes.cast(nbytes, _c), ngroups, nlevels,
            mask.data_ptr(), sizes.data_ptr(), pos.data_ptr(), new_sizes.data_ptr(),
            nblocks, m, b0, block.data_ptr() if block is not None else None,
            common.stream_of(dev),
        )
    # one launch either way; the multi-group launch (the KV cache's k and v)
    # is counted apart so a run shows which of the two it went through
    name = "push_back" if ngroups == 1 else "push_back_multi"
    common.check_status(rc, lib, name)
    common.count_launch(name)
    if block is None:
        return new_sizes, pos
    common.count_launch("counter_plane")
    return new_sizes, pos, block
