"""K3 launcher: the CUDA fused push-back (``csrc/push_back.cu``).

Replaces ``repro/kernels/push_back/kernel.py::push_back_pallas``.  The level
tensors are written in place — the counterpart of the reference's
``input_output_aliases`` on the levels.  Items of any shape are carried as
``item_bytes`` of raw bits per lane.  The C side takes a [group][level]
pointer table: one launch writes up to four payload groups that share the
mask (the KV cache's k and v; an int8 cache's k, v and their two bf16
scale groups), each with its own item size and copy unit.

``instrument=True`` launches the counting instantiation (K15) and returns
its ``(NSLOTS,)`` int32 counter block (``obs/device.py``) as a third output.

The launch follows :func:`push_back_plan`, from shapes alone: the row scan's
block size from m and the copy units a lane carries, the tiles a row takes,
and whether a count pass runs first (a row of one tile is one launch).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import indexing
from repro_torch.kernels import _build, common
from repro_torch.obs import device as obs_device

__all__ = ["push_back_cuda", "push_back_cuda_multi", "push_back_plan", "PushBackPlan",
           "empty_launch_cuda", "launch_name", "PAYLOAD_DTYPES"]

# Payloads are copied as bits, in units of 16, 4, 2 or 1 bytes.
PAYLOAD_DTYPES = (torch.float32, torch.int32, torch.bfloat16, torch.float16, torch.int8)
MAX_LEVELS = 32
MAX_GROUPS = 4  # csrc/push_back.cu kMaxGroups


def launch_name(ngroups: int) -> str:
    """The name a launch of ``ngroups`` payload groups counts under: one
    group (the GGArray append), two or three (the KV cache's k and v), or
    four (an int8 cache's k, v and their scales), so a run shows which
    form it went through."""
    return "push_back" if ngroups == 1 else "push_back_four" if ngroups == 4 else "push_back_multi"

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _lib():
    lib = _build.library("push_back")
    if getattr(lib, "ready", False):  # argument types set once per library
        return lib
    lib.rt_push_back.argtypes = [
        _c, _c, _c, _c, ctypes.c_int, ctypes.c_int,  # tables, units, ngroups, nlevels
        _c, ctypes.c_int,  # level shard counts, shard
        _c, _c, _c, _c, _c,  # mask, sizes, counts, pos_out, new_sizes
        _i64, _i64, _i64, ctypes.c_int, _i64, _c, _c,  # nblocks, m, b0, threads, tiles, ctr, stream
    ]
    lib.rt_push_back.restype = ctypes.c_int
    lib.rt_empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, _c]
    lib.rt_empty_launch.restype = ctypes.c_int
    lib.ready = True
    return lib


class PushBackPlan(NamedTuple):
    threads: int  # the block: 64, 128 or 256
    tiles: int  # tiles a row, of threads * 16 lanes
    count_pass: bool  # a count pass runs before the write pass


def push_back_plan(m: int, units: int) -> PushBackPlan:
    """K3's launch for a wave of ``m`` lanes a row whose live lane carries
    ``units`` copy units over all its groups: the block holds the row's
    lanes or the units, at most 256 threads (``common.scan_threads``); a
    row of more than one tile takes a count pass first.  The Engine's
    decode append (m = 1, k and v of 32 16-byte units each) is one launch
    of 64-thread blocks."""
    threads = common.scan_threads(m, m * units)
    tiles = common.row_tiles(m, threads)
    return PushBackPlan(threads, tiles, tiles > 1)


def empty_launch_cuda(dev: torch.device, blocks: int, threads: int) -> None:
    """Launch an empty kernel of ``blocks`` x ``threads`` on ``dev``'s
    current stream: the launch floor that K3's decode append is timed
    against.  Not a port kernel, and not counted."""
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.rt_empty_launch(blocks, threads, common.stream_of(dev))
    common.check_status(rc, lib, "empty_launch")


def push_back_cuda(
    levels: tuple[torch.Tensor, ...],
    sizes: torch.Tensor,
    b0: int,
    elems: torch.Tensor,
    mask: torch.Tensor,
    *,
    instrument: bool = False,
    shard: int = 0,
    nshards: "int | tuple[int, ...]" = 1,
) -> tuple:
    """Launch K3 on one payload group → (new sizes, positions[, counter block]).

    ``levels``: level b ``(nblocks, B0·2^b, *item)``, written in place;
    ``sizes``: ``(nblocks,)`` int32; ``elems``: ``(nblocks, m, *item)``;
    ``mask``: ``(nblocks, m)`` bool.  All contiguous, on one CUDA device.
    """
    return push_back_cuda_multi((levels,), sizes, b0, (elems,), mask, instrument=instrument,
                                shard=shard, nshards=nshards)


def push_back_cuda_multi(
    level_groups: tuple[tuple[torch.Tensor, ...], ...],
    sizes: torch.Tensor,
    b0: int,
    elem_groups: tuple[torch.Tensor, ...],
    mask: torch.Tensor,
    *,
    instrument: bool = False,
    shard: int = 0,
    nshards: "int | tuple[int, ...]" = 1,
) -> tuple:
    """Launch K3 once over ``len(level_groups)`` payload groups → (new sizes,
    positions), and with ``instrument`` the counter block.

    Every group shares the one offset scan and the one mask: group g's wave
    ``elem_groups[g]`` ``(nblocks, m, *item_g)`` lands in its own levels
    ``level_groups[g]`` (level b ``(nblocks, B0·2^b, *item_g)``, written in
    place) at the same positions — the KV cache's k and v in one launch.

    The shard form: level b is slice ``shard`` of a level split
    ``nshards_b`` ways along its slots, ``(nblocks, B0·2^b / nshards_b,
    *item_g)``; the kernel drops a lane outside the slice and shifts the
    others' slots by ``shard·B0·2^b / nshards_b`` (``ref.push_back``).
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
    shards = common.level_shards(nshards, nlevels)
    widths = [w // n for w, n in zip(indexing.bucket_sizes(b0, nlevels), shards)]
    if any(w % n for w, n in zip(indexing.bucket_sizes(b0, nlevels), shards)) or any(
            n > 1 and not 0 <= shard < n for n in shards):
        raise ValueError(f"push_back: shard {shard} of level shard counts {shards}: each count "
                         f"must divide its level and exceed the shard")
    item_bytes, unit_bytes = [], []
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
        unit_bytes.append(common.copy_unit(nbytes, elems, *levels))
    pos = torch.empty((nblocks, m), dtype=torch.int32, device=dev)
    new_sizes = torch.empty_like(sizes)
    block = obs_device.new_block(dev) if instrument else None
    if nblocks == 0 or m == 0:
        new_sizes.copy_(sizes)
        return (new_sizes, pos) if block is None else (new_sizes, pos, block)
    lib = _lib()
    ngroups = len(level_groups)
    plan = push_back_plan(m, sum(n // u for n, u in zip(item_bytes, unit_bytes)))
    counts = (torch.empty(nblocks * plan.tiles, dtype=torch.int32, device=dev)
              if plan.count_pass else None)
    level_ptrs = (ctypes.c_void_p * (ngroups * nlevels))(
        *(lv.data_ptr() for levels in level_groups for lv in levels))
    elem_ptrs = (ctypes.c_void_p * ngroups)(*(e.data_ptr() for e in elem_groups))
    nbytes = (ctypes.c_int64 * ngroups)(*item_bytes)
    units = (ctypes.c_int * ngroups)(*unit_bytes)
    shard_counts = (ctypes.c_int * nlevels)(*shards)
    with torch.cuda.device(dev):
        rc = lib.rt_push_back(
            ctypes.cast(level_ptrs, _c), ctypes.cast(elem_ptrs, _c),
            ctypes.cast(nbytes, _c), ctypes.cast(units, _c), ngroups, nlevels,
            ctypes.cast(shard_counts, _c), shard,
            mask.data_ptr(), sizes.data_ptr(), counts.data_ptr() if counts is not None else None,
            pos.data_ptr(), new_sizes.data_ptr(), nblocks, m, b0, plan.threads, plan.tiles,
            block.data_ptr() if block is not None else None, common.stream_of(dev),
        )
    name = launch_name(ngroups)
    common.check_status(rc, lib, name)
    common.count_launch(name)
    if block is None:
        return new_sizes, pos
    common.count_launch("counter_plane")
    return new_sizes, pos, block
