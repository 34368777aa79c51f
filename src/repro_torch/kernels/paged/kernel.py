"""K8/K9, K12 and K10/K11 launchers: the CUDA paged gather and slab append
(``csrc/paged.cu``) and the paged decode attention (``csrc/paged_attend.cu``).

K8 replaces ``repro/kernels/paged/kernel.py::paged_gather_pallas``, K9
``::paged_gather_pallas_extents``, K12 ``::slab_append_pallas``, K10
``::paged_attend_pallas`` and K11 ``::paged_attend_pallas_extents``.  Every
kernel addresses the pool through
:func:`repro_torch.kernels.common.extent_table`, so one launch covers every
extent.  Items of any shape are carried as raw
bytes (16-byte units where sizes and addresses allow).  The slab append
writes the extents in place — the counterpart of the reference's donated,
aliased pool.  The gather and the attention take ``instrument=True``: they
launch their counting instantiations (K15) and also return the ``(NSLOTS,)``
int32 counter block (``obs/device.py``).

The gather's plan (:func:`gather_plan`), the append's
(:func:`append_plan`) and the attention's split count
(:func:`attend_splits`) are computed here from shapes (and, for the split,
the SM count), never from data.  The attention is one launch: its blocks
merge through a scratch of partial states and ticket counters that live
here, one of each per device, made once and grown, never inside a
CUDA-graph capture (:func:`attend_buffers`), so launches on one device must
run in stream order.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build, common
from repro_torch.obs import device as obs_device

__all__ = ["paged_gather_cuda", "slab_append_cuda", "paged_attend_cuda", "gather_plan",
           "attend_splits", "attend_buffers", "GatherPlan", "append_plan", "AppendPlan",
           "slab_window", "rank_segments"]

_c = ctypes.c_void_p
_i64 = ctypes.c_int64
_int = ctypes.c_int


def _lib():
    lib = _build.library("paged")
    if getattr(lib, "ready", False):  # argument types set once per library
        return lib
    lib.rt_paged_gather.argtypes = [
        _c, _int, _i64, _int, _c, _c, _i64, _i64, _int, _c, _c,  # .. unit, ctr, stream
    ]
    lib.rt_paged_gather.restype = _int
    lib.rt_gather_block_pieces.argtypes, lib.rt_gather_block_pieces.restype = [], _int
    if lib.rt_gather_block_pieces() != GATHER_BLOCK_PIECES:
        raise RuntimeError("paged_gather: the library's block size differs from gather_plan's")
    lib.rt_slab_append.argtypes = [
        _c, _int, _i64, _c, _c, _c, _c, _c, _c, _c, _c, _c,  # table .. new_sizes
        _i64, _i64, _i64, _i64, _int,  # narrays, m, T, item_bytes, unit
        _int, _i64, _i64, _int, _c,  # threads, tiles, nseg, chunk, stream
    ]
    lib.rt_slab_append.restype = _int
    lib.ready = True
    return lib


def _attend_lib():
    lib = _build.library("paged_attend")
    if getattr(lib, "ready", False):  # argument types set once per library
        return lib
    lib.rt_paged_attend.argtypes = [
        _c, _c, _int, _i64, _int, _c, _c, _c,  # ktable .. lengths
        _c, _c, _c, _int,  # part, tickets, out, dtype
        _i64, _i64, _i64, _i64, _i64, _i64, _i64, _c, _c,  # B, KH, G, D, P, T, nsplit, ctr, stream
    ]
    lib.rt_paged_attend.restype = _int
    for fn in (lib.rt_paged_attend_max_splits, lib.rt_paged_attend_group):
        fn.argtypes, fn.restype = [], _int
    if (lib.rt_paged_attend_max_splits(), lib.rt_paged_attend_group()) != (ATTEND_MAX_SPLITS,
                                                                           ATTEND_GROUP):
        raise RuntimeError("paged_attend: the library's split limit or group differs from this module's")
    lib.ready = True
    return lib


# The gather's plan (csrc/paged.cu): one pass over the output, a block per
# GATHER_BLOCK_PIECES pieces (256 threads, two pieces each).
GATHER_BLOCK_PIECES = 512


class GatherPlan(NamedTuple):
    slab_units: int  # pieces per slab
    pieces: int  # npages * slab_units
    grid: int  # blocks: ceil(pieces / GATHER_BLOCK_PIECES)


def gather_plan(npages: int, slab_bytes: int, unit: int) -> GatherPlan:
    """The paged gather's plan for ``npages`` pages of ``slab_bytes`` copied
    in ``unit``-byte pieces: block b copies pieces [512 b, 512 (b + 1)) of
    the output, and the pages they touch are resolved once per block."""
    slab_units = slab_bytes // unit
    pieces = npages * slab_units
    return GatherPlan(slab_units, pieces, -(-pieces // GATHER_BLOCK_PIECES))


# The append's plan (csrc/paged.cu): the row scan of csrc/common.cuh, whose
# write pass publishes each row's rank at every APPEND_SEG_LANES lanes, then
# a copy block per chunk of a slab's slots.
APPEND_SEG_LANES = 1024  # kSegLanes
APPEND_MAX_CHUNK = 2048  # kMaxChunk: slots a copy block, at most
APPEND_CHUNK_BYTES = 32 << 10  # a copy block's item bytes, where the slab allows


class AppendPlan(NamedTuple):
    threads: int  # the scan pass's block: 64, 128 or 256
    tiles: int  # tiles a row, of threads * 16 lanes
    count_pass: bool  # a count pass runs before the scan pass
    segments: int  # rank-search segments a row: ceil(m / APPEND_SEG_LANES)
    chunk: int  # slots a copy block
    chunks: int  # copy blocks a slab


def append_plan(m: int, item_bytes: int, T: int) -> AppendPlan:
    """K12's launch for a wave of ``m`` lanes a row of ``item_bytes`` items
    into slabs of ``T`` slots: the scan pass's block from m alone (it copies
    nothing), and copy blocks of the largest power-of-two chunk of slots
    within APPEND_CHUNK_BYTES, at most APPEND_MAX_CHUNK and T — a whole
    2048-slot slab of 4-byte items, 16 slots of a 2 KB KV item."""
    threads = common.scan_threads(m, 0)
    tiles = common.row_tiles(m, threads)
    chunk = 1 << max(APPEND_CHUNK_BYTES // max(item_bytes, 1), 1).bit_length() - 1
    chunk = max(min(chunk, APPEND_MAX_CHUNK, T), 1)
    return AppendPlan(threads, tiles, tiles > 1, -(-m // APPEND_SEG_LANES), chunk, -(-T // chunk))


def slab_window(c: int, chunk: int, T: int, base: int, size: int, count: int) -> tuple[int, int]:
    """The slots ``[j_lo, j_hi)`` that copy block ``c`` of a slab fills (empty
    where ``j_lo >= j_hi``): slot j holds rank ``base + j − size`` of its
    owner's wave, live where ``0 ≤ rank < count``, cut to the chunk's
    ``[c · chunk, (c + 1) · chunk) ∩ [0, T)``."""
    j_lo = max(c * chunk, size - base)
    j_hi = min(c * chunk + chunk, T, size + count - base)
    return j_lo, j_hi


def rank_segments(seg, r_lo: int, r_hi: int) -> tuple[int, int]:
    """The copy block's search of its owner's segment prefix ``seg``
    (``nseg + 1`` entries, non-decreasing, ``seg[0] = 0``, ``seg[nseg]`` the
    count) for ranks ``[r_lo, r_hi)``, ``0 ≤ r_lo < r_hi ≤ seg[nseg]`` →
    ``(g0, g1)``: g0 the last segment starting at or before ``r_lo`` (the
    segments that do, less one), g1 the first after it starting at or past
    ``r_hi`` (the entries below ``r_hi``); the ranks' lanes lie in segments
    ``g0 .. g1 − 1``.  The block counts both in one round of loads."""
    seg = np.asarray(seg)
    nseg = len(seg) - 1
    return int((seg[:nseg] <= r_lo).sum()) - 1, int((seg < r_hi).sum())


ATTEND_HEAD_DIMS = (16, 32, 64, 128)
ATTEND_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ATTEND_MAX_GROUP = 16
ATTEND_MAX_SPLITS = 128  # the kernel's merge holds this many states (kMaxSplits)
ATTEND_GROUP = 8  # splits a first-level merge takes (kGroup)
ATTEND_BLOCKS_PER_SM = 4  # blocks a SM in the wave (csrc/paged_attend.cu's kBlocksPerSm)
ATTEND_SPLIT_KEYS = 32  # no more splits than one per this many positions
ATTEND_TICKETS0 = 256  # the ticket buffer's first size, in counters
ATTEND_PARTS0 = 1 << 18  # the partial-state scratch's first size, in floats (1 MB)
_attend_tickets: dict[torch.device, torch.Tensor] = {}
_attend_parts: dict[torch.device, torch.Tensor] = {}
_attend_retired: list[torch.Tensor] = []  # replaced buffers a captured graph may still use


def attend_splits(P: int, T: int, bkh: int, sms: int) -> int:
    """Blocks per (sequence, head) of the paged attention: as many as fill
    one wave of ATTEND_BLOCKS_PER_SM resident blocks a SM over the ``bkh``
    pairs (a block's chain of loads, not the bytes, sets its time), at most
    one per ATTEND_SPLIT_KEYS of the P·T positions a page table addresses
    and ATTEND_MAX_SPLITS.  From shapes alone: lengths are never read."""
    return max(1, min(ATTEND_BLOCKS_PER_SM * sms // max(bkh, 1), -(-(P * T) // ATTEND_SPLIT_KEYS),
                      ATTEND_MAX_SPLITS))


def attend_buffers(dev: torch.device, n_tickets: int, n_parts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The device's ticket buffer (at least ``n_tickets`` int32 zeros: per
    (sequence, head) a counter per group of ATTEND_GROUP splits and a final
    one) and partial-state scratch (at least ``n_parts`` f32: the splits'
    and the groups' states), made once and grown, never inside a CUDA-graph
    capture (``common.device_buffer``)."""
    tickets = common.device_buffer(_attend_tickets, _attend_retired, dev, n_tickets, torch.int32,
                                   first=ATTEND_TICKETS0, zero=True, what="paged_attend tickets")
    parts = common.device_buffer(_attend_parts, _attend_retired, dev, n_parts, torch.float32,
                                 first=ATTEND_PARTS0, zero=False, what="paged_attend scratch")
    return tickets, parts


def _check_extents(extents: tuple[torch.Tensor, ...], what: str) -> tuple[torch.device, int, tuple]:
    """→ (device, slab size T, item shape); every extent (S_e, T, *item) alike."""
    if not extents:
        raise ValueError(f"{what}: no extents")
    dev = extents[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: tensors on {dev}, expected cuda")
    T, item = extents[0].shape[1], tuple(extents[0].shape[2:])
    for e, ext in enumerate(extents):
        common.check_tensor(ext, f"{what} extent {e}", device=dev, dtypes=(extents[0].dtype,))
        if ext.ndim < 2 or tuple(ext.shape[1:]) != (T, *item):
            raise ValueError(f"{what} extent {e}: shape {tuple(ext.shape)}, expected (S_e, {T}, *{item})")
    return dev, T, item


def _item_bytes(t: torch.Tensor, item: tuple) -> int:
    n = t.element_size()
    for d in item:
        n *= d
    return n


def paged_gather_cuda(
    extents: tuple[torch.Tensor, ...], pages: torch.Tensor, *, clip_high: bool,
    instrument: bool = False,
):
    """Launch K8 (one extent) or K9 (several) → ``(N, P·T, *item)``, and with
    ``instrument`` the counter block (launch, live and masked page tiles).

    ``extents``: each ``(S_e, T, *item)``, in global slab-id order, none
    empty; ``pages``: ``(N, P)`` int32 global slab ids.  Page −1 reads
    zeros, and so do ids past the pool unless ``clip_high`` (then they read
    the last slab, as the reference's flat-pool gather does).
    """
    dev, T, item = _check_extents(extents, "paged_gather")
    common.check_tensor(pages, "paged_gather pages", device=dev, dtypes=(torch.int32,))
    if pages.ndim != 2:
        raise ValueError(f"paged_gather pages: expected (N, P), got {tuple(pages.shape)}")
    if any(e.shape[0] == 0 for e in extents):
        raise ValueError("paged_gather: empty extents must be dropped first")
    N, P = pages.shape
    out = torch.empty((N, P * T, *item), dtype=extents[0].dtype, device=dev)
    block = obs_device.new_block(dev) if instrument else None
    if out.numel() == 0:
        return out if block is None else (out, block)
    n_slabs = sum(e.shape[0] for e in extents)
    slab_bytes = T * _item_bytes(extents[0], item)
    unit = common.copy_unit(slab_bytes, out, *extents)
    table = common.extent_table(tuple(extents))
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.rt_paged_gather(
            table.data_ptr(), len(extents), n_slabs, int(clip_high), pages.data_ptr(),
            out.data_ptr(), N * P, slab_bytes, unit,
            block.data_ptr() if block is not None else None, common.stream_of(dev),
        )
    name = "paged_gather" if len(extents) == 1 else "paged_gather_extents"
    common.check_status(rc, lib, name)
    common.count_launch(name)
    if block is None:
        return out
    common.count_launch("counter_plane")
    return out, block


def slab_append_cuda(
    extents: tuple[torch.Tensor, ...],
    owners: torch.Tensor,
    bases: torch.Tensor,
    sizes: torch.Tensor,
    elems: torch.Tensor,
    mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K12 → (new sizes, positions); the extents are written in place.
    One call, counted once, issues up to three kernels (:func:`append_plan`);
    beyond its outputs it allocates only the ``(N, tiles)`` tile counts and
    the ``(N, m / 1024 + 1)`` segment prefixes.

    ``extents``: each ``(S_e, T, *item)`` in global slab-id order;
    ``owners``/``bases``: ``(n_slabs,)`` int32; ``sizes``: ``(N,)`` int32;
    ``elems``: ``(N, m, *item)`` of the extents' dtype; ``mask``: ``(N, m)``
    bool.  All contiguous, on one CUDA device.
    """
    dev, T, item = _check_extents(extents, "slab_append")
    if elems.ndim < 2:
        raise ValueError(f"slab_append elems: expected (N, m, *item), got {tuple(elems.shape)}")
    N, m = elems.shape[:2]
    n_slabs = sum(e.shape[0] for e in extents)
    common.check_tensor(elems, "slab_append elems", device=dev, dtypes=(extents[0].dtype,),
                        shape=(N, m, *item))
    common.check_tensor(mask, "slab_append mask", device=dev, dtypes=(torch.bool,), shape=(N, m))
    common.check_tensor(sizes, "slab_append sizes", device=dev, dtypes=(torch.int32,), shape=(N,))
    for name, t in (("owners", owners), ("bases", bases)):
        common.check_tensor(t, f"slab_append {name}", device=dev, dtypes=(torch.int32,),
                            shape=(n_slabs,))
    pos = torch.empty((N, m), dtype=torch.int32, device=dev)
    new_sizes = torch.empty_like(sizes)
    if N == 0 or m == 0:
        new_sizes.copy_(sizes)
        return new_sizes, pos
    live = tuple(e for e in extents if e.shape[0] > 0) or extents[:1]
    item_bytes = _item_bytes(elems, item)
    unit = common.copy_unit(item_bytes, elems, *live)
    plan = append_plan(m, item_bytes, T)
    counts = torch.empty(N * plan.tiles, dtype=torch.int32, device=dev) if plan.count_pass else None
    segpre = torch.empty((N, plan.segments + 1), dtype=torch.int32, device=dev)
    table = common.extent_table(live)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.rt_slab_append(
            table.data_ptr(), len(live), n_slabs, owners.data_ptr(), bases.data_ptr(),
            sizes.data_ptr(), elems.data_ptr(), mask.data_ptr(),
            counts.data_ptr() if counts is not None else None, segpre.data_ptr(),
            pos.data_ptr(), new_sizes.data_ptr(), N, m, T, item_bytes, unit, plan.threads,
            plan.tiles, plan.segments, plan.chunk, common.stream_of(dev),
        )
    common.check_status(rc, lib, "slab_append")
    common.count_launch("slab_append")
    return new_sizes, pos


def paged_attend_cuda(
    q: torch.Tensor,
    k_extents: tuple[torch.Tensor, ...],
    v_extents: tuple[torch.Tensor, ...],
    pages: torch.Tensor,
    lengths: torch.Tensor,
    *,
    instrument: bool = False,
):
    """Launch K10 (one extent) or K11 (several) → ``(B, KH, G, D)`` f32, and
    with ``instrument`` the counter block (the reference's walk over (B, KH,
    P): launch, visited and skipped tiles, score and masked lanes).

    ``q``: ``(B, KH, G, D)`` f32, pre-scaled; ``k_extents``/``v_extents``:
    each ``(S_e, T, KH, D)``, the token-major slabs the cache holds, in global
    slab-id order, none empty, the same geometry for k and v, 16-byte
    aligned; ``pages``: ``(B, P)`` int32 global slab ids; ``lengths``:
    ``(B,)`` int32.  Page −1 and keys at or past the length are left out;
    ids past the pool read the last slab of one flat pool and are skipped
    through extents.  One launch; beyond the output (and the counter block)
    it allocates nothing once :func:`attend_buffers` holds this shape.
    """
    dev, T, item = _check_extents(k_extents, "paged_attend k")
    dev_v, T_v, item_v = _check_extents(v_extents, "paged_attend v")
    if (dev_v, T_v, item_v) != (dev, T, item) or [e.shape[0] for e in k_extents] != [
            e.shape[0] for e in v_extents] or v_extents[0].dtype != k_extents[0].dtype:
        raise ValueError("paged_attend: k and v pools differ in geometry or dtype")
    if len(item) != 2:
        raise ValueError(f"paged_attend pool: expected slabs (S_e, T, KH, D), got item {item}")
    KH, D = item
    if q.ndim != 4:
        raise ValueError(f"paged_attend q: expected (B, KH, G, D), got {tuple(q.shape)}")
    B, _, G, _ = q.shape
    common.check_tensor(q, "paged_attend q", device=dev, dtypes=(torch.float32,),
                        shape=(B, KH, G, D))
    common.check_tensor(lengths, "paged_attend lengths", device=dev, dtypes=(torch.int32,),
                        shape=(B,))
    common.check_tensor(pages, "paged_attend pages", device=dev, dtypes=(torch.int32,))
    if pages.ndim != 2 or pages.shape[0] != B:
        raise ValueError(f"paged_attend pages: expected ({B}, P), got {tuple(pages.shape)}")
    if D not in ATTEND_HEAD_DIMS:
        raise ValueError(f"paged_attend: head dim {D} not in {ATTEND_HEAD_DIMS}")
    if not 1 <= G <= ATTEND_MAX_GROUP:
        raise ValueError(f"paged_attend: {G} query heads per kv head, supported 1..{ATTEND_MAX_GROUP}")
    dtype = ATTEND_POOL_DTYPES.get(k_extents[0].dtype)
    if dtype is None:
        raise TypeError(f"paged_attend: pool dtype {k_extents[0].dtype} not in "
                        f"{tuple(ATTEND_POOL_DTYPES)}")
    if any(e.shape[0] == 0 for e in k_extents):
        raise ValueError("paged_attend: empty extents must be dropped first")
    if any(t.data_ptr() % 16 for t in (q, *k_extents, *v_extents)):
        raise ValueError("paged_attend: q and every extent must be 16-byte aligned")
    P = pages.shape[1]
    out = torch.empty((B, KH, G, D), dtype=torch.float32, device=dev)
    block = obs_device.new_block(dev) if instrument else None
    if B == 0:
        return out if block is None else (out, block)
    nsplit = attend_splits(P, T, B * KH, common.sm_count(dev))
    ngroups = -(-nsplit // ATTEND_GROUP)
    tickets, part = attend_buffers(dev, B * KH * (ngroups + 1),
                                   (D + 2) * B * KH * (nsplit + ngroups) * G)
    n_slabs = sum(e.shape[0] for e in k_extents)
    ktable = common.extent_table(tuple(k_extents))
    vtable = common.extent_table(tuple(v_extents))
    lib = _attend_lib()
    with torch.cuda.device(dev):
        rc = lib.rt_paged_attend(
            ktable.data_ptr(), vtable.data_ptr(), len(k_extents), n_slabs,
            int(len(k_extents) == 1), q.data_ptr(), pages.data_ptr(), lengths.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), out.data_ptr(), dtype, B, KH, G, D, P, T, nsplit,
            block.data_ptr() if block is not None else None, common.stream_of(dev),
        )
    name = "paged_attend" if len(k_extents) == 1 else "paged_attend_extents"
    common.check_status(rc, lib, name)
    common.count_launch(name)
    if block is None:
        return out
    common.count_launch("counter_plane")
    return out, block
