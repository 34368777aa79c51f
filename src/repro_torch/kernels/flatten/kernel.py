"""K6/K7 launchers: CUDA compaction and segmented gather (``csrc/flatten.cu``).

K6 replaces ``repro/kernels/flatten/kernel.py::compact_blocks_pallas``, K7
``::segmented_gather_pallas``.  Both move bits: 2- and 4-byte scalar items.
K7 has two source forms of one kernel: the ``(nblocks, cap)`` plane
(:func:`segmented_gather_cuda`, the arena's freeze) and the bucket levels
themselves (:func:`segmented_gather_levels_cuda`, the GGArray freeze, which
then writes and reads no plane).  With ``instrument=True`` K7 launches its
counting instantiation (K15) and also returns the ``(NSLOTS,)`` int32
counter block (``obs/device.py``).

K7's plan in Python, replayed by ``tests/test_torch_freeze_plan.py``: a
block per :data:`RANGE_BYTES` of output walks the owners of its range
(:func:`gather_pieces`), splits each live piece at the level boundaries in
the levels form (:func:`level_runs`) and counts its share of the
counters (:func:`range_rows`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import indexing
from repro_torch.kernels import _build, common
from repro_torch.kernels.flatten.ref import SEG_TILE
from repro_torch.obs import device as obs_device

__all__ = ["compact_blocks_cuda", "segmented_gather_cuda", "segmented_gather_levels_cuda",
           "ITEM_DTYPES", "RANGE_BYTES", "Piece", "gather_pieces", "range_rows", "level_runs"]

ITEM_DTYPES = (torch.float32, torch.int32, torch.bfloat16, torch.float16)
MAX_LEVELS = 32
RANGE_BYTES = 16384  # K7's output bytes per block (kRangeBytes)

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _lib():
    lib = _build.library("flatten")
    lib.rt_compact_blocks.argtypes = [_c, ctypes.c_int, _c, _i64, _i64, ctypes.c_int, _c]
    lib.rt_compact_blocks.restype = ctypes.c_int
    lib.rt_segmented_gather.argtypes = [_c, _c, _c, _c, _i64, _i64, ctypes.c_int, _c, _c]
    lib.rt_segmented_gather.restype = ctypes.c_int
    lib.rt_segmented_gather_levels.argtypes = [_c, ctypes.c_int, _i64, _c, _c, _c, _i64,
                                               ctypes.c_int, _c, _c]
    lib.rt_segmented_gather_levels.restype = ctypes.c_int
    lib.rt_gather_range_bytes.argtypes = []
    lib.rt_gather_range_bytes.restype = ctypes.c_int
    if lib.rt_gather_range_bytes() != RANGE_BYTES:
        raise RuntimeError("segmented_gather: the library's range differs from RANGE_BYTES")
    return lib


def _check_levels(levels: tuple[torch.Tensor, ...], b0: int, what: str) -> torch.device:
    dev = levels[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}_cuda: tensors on {dev}, expected cuda")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{what}: {len(levels)} levels, supported 1..{MAX_LEVELS}")
    nblocks = levels[0].shape[0]
    for b, (level, width) in enumerate(zip(levels, indexing.bucket_sizes(b0, len(levels)))):
        common.check_tensor(level, f"{what} level {b}", device=dev,
                            dtypes=(levels[0].dtype,), shape=(nblocks, width))
    if levels[0].dtype not in ITEM_DTYPES:
        raise TypeError(f"{what}: dtype {levels[0].dtype} not in {ITEM_DTYPES}")
    return dev


def _level_ptrs(levels: tuple[torch.Tensor, ...]):
    return (ctypes.c_void_p * len(levels))(*(lv.data_ptr() for lv in levels))


def _check_tables(starts: torch.Tensor, ends: torch.Tensor, nblocks: int, dev: torch.device) -> None:
    for name, t in (("starts", starts), ("ends", ends)):
        common.check_tensor(t, f"segmented_gather {name}", device=dev,
                            dtypes=(torch.int32,), shape=(nblocks,))


def compact_blocks_cuda(levels: tuple[torch.Tensor, ...], b0: int) -> torch.Tensor:
    """Launch K6: level b ``(nblocks, B0·2^b)`` → ``(nblocks, cap)``."""
    dev = _check_levels(levels, b0, "compact_blocks")
    nblocks = levels[0].shape[0]
    cap = indexing.capacity(b0, len(levels))
    out = torch.empty((nblocks, cap), dtype=levels[0].dtype, device=dev)
    if nblocks == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.rt_compact_blocks(
            ctypes.cast(_level_ptrs(levels), _c), len(levels), out.data_ptr(), nblocks, b0,
            out.element_size(), common.stream_of(dev),
        )
    common.check_status(rc, lib, "compact_blocks")
    common.count_launch("compact_blocks")
    return out


def _gather(launch, out: torch.Tensor, dev: torch.device, instrument: bool):
    """Launch K7 through ``launch(lib, ctr_ptr, stream)``; count it."""
    block = obs_device.new_block(dev) if instrument else None
    if out.numel() == 0:
        return out if block is None else (out, block)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = launch(lib, block.data_ptr() if block is not None else None, common.stream_of(dev))
    common.check_status(rc, lib, "segmented_gather")
    common.count_launch("segmented_gather")
    if block is None:
        return out
    common.count_launch("counter_plane")
    return out, block


def segmented_gather_cuda(
    compact: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor, *, instrument: bool = False
):
    """Launch K7 on a plane: ``(nblocks, cap)`` + int32 starts/ends →
    ``(nblocks·cap,)``, and with ``instrument`` the counter block (launch,
    rows touched)."""
    dev = compact.device
    if dev.type != "cuda":
        raise ValueError(f"segmented_gather_cuda: tensors on {dev}, expected cuda")
    common.check_tensor(compact, "segmented_gather compact", device=dev, dtypes=ITEM_DTYPES)
    if compact.ndim != 2:
        raise ValueError(f"segmented_gather compact: expected (nblocks, cap), got {tuple(compact.shape)}")
    nblocks, cap = compact.shape
    _check_tables(starts, ends, nblocks, dev)
    out = torch.empty((nblocks * cap,), dtype=compact.dtype, device=dev)
    return _gather(lambda lib, ctr, stream: lib.rt_segmented_gather(
        compact.data_ptr(), starts.data_ptr(), ends.data_ptr(), out.data_ptr(), nblocks, cap,
        compact.element_size(), ctr, stream), out, dev, instrument)


def segmented_gather_levels_cuda(
    levels: tuple[torch.Tensor, ...], b0: int, starts: torch.Tensor, ends: torch.Tensor, *,
    instrument: bool = False,
):
    """Launch K7 on the bucket levels (level b ``(nblocks, B0·2^b)``) + int32
    starts/ends → ``(nblocks·cap,)``: the same output and counters as
    :func:`segmented_gather_cuda` on ``compact_blocks(levels, b0)``."""
    dev = _check_levels(levels, b0, "segmented_gather_levels")
    nblocks = levels[0].shape[0]
    _check_tables(starts, ends, nblocks, dev)
    cap = indexing.capacity(b0, len(levels))
    out = torch.empty((nblocks * cap,), dtype=levels[0].dtype, device=dev)
    ptrs = _level_ptrs(levels)
    return _gather(lambda lib, ctr, stream: lib.rt_segmented_gather_levels(
        ctypes.cast(ptrs, _c), len(levels), b0, starts.data_ptr(), ends.data_ptr(), out.data_ptr(),
        nblocks, out.element_size(), ctr, stream), out, dev, instrument)


# ---------------------------------------------------------------------------
# K7's plan, as its blocks compute it
# ---------------------------------------------------------------------------

class Piece(NamedTuple):
    """Output ``[a, b)`` of one K7 block: ``kind`` "copy" (owner's items from
    offset ``off``), "clamp" (the owner's item at cap − 1) or "zero"."""
    kind: str
    a: int
    b: int
    owner: int
    off: int


def _count_le(starts: np.ndarray, i: int) -> int:
    return int(np.searchsorted(starts, i, side="right"))


def gather_pieces(starts, ends, nblocks: int, cap: int, esize: int) -> list[list[Piece]]:
    """Each K7 block's pieces, in the order it writes them: the owners of
    its range's first element and of its last tile's last element by two
    upper-bound searches, then each walked owner's live, clamped and gap
    pieces cut to the range (the levels form splits a copy piece further,
    :func:`level_runs`)."""
    st, en = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    n_out, rng = nblocks * cap, RANGE_BYTES // esize
    blocks = []
    for r0 in range(0, n_out, rng):
        r1 = min(r0 + rng, n_out)
        r_end = r0 + -(-(r1 - r0) // SEG_TILE) * SEG_TILE - 1
        u0, u_end = _count_le(st, r0), _count_le(st, r_end)
        pieces = []
        if u0 == 0 and r0 < min(r1, st[0]):
            pieces.append(Piece("zero", r0, int(min(r1, st[0])), -1, 0))
        for o in range(max(u0 - 1, 0), max(u_end, 1)):
            s = int(st[o])
            nxt = int(st[o + 1]) if o + 1 < nblocks else n_out
            live_end = min(max(int(en[o]), s), nxt)
            copy_end = min(live_end, s + cap)
            i = max(s, r0)
            for kind, end in (("copy", copy_end), ("clamp", live_end), ("zero", nxt)):
                j = min(end, r1)
                if i < j:
                    pieces.append(Piece(kind, i, j, o, i - s))
                    i = j
        blocks.append(pieces)
    return blocks


def range_rows(starts, nblocks: int, cap: int, esize: int) -> np.ndarray:
    """Each K7 block's ``flatten.rows_touched``: its 256-element tiles,
    minus those before ``starts[0]``, plus its walked owners
    ``o >= #{starts <= r0}`` whose start is not a tile's first element."""
    st = np.asarray(starts, np.int64)
    n_out, rng = nblocks * cap, RANGE_BYTES // esize
    rows = []
    for r0 in range(0, n_out, rng):
        ntiles = -(-(min(r0 + rng, n_out) - r0) // SEG_TILE)
        u0, u_end = _count_le(st, r0), _count_le(st, r0 + ntiles * SEG_TILE - 1)
        before = -(-(int(st[0]) - r0) // SEG_TILE) if st[0] > r0 else 0
        rows.append(ntiles - min(before, ntiles) + int(np.count_nonzero(st[u0:u_end] % SEG_TILE)))
    return np.asarray(rows, np.int64)


def level_runs(off: int, n: int, b0: int) -> list[tuple[int, int, int]]:
    """Offsets ``[off, off + n)`` of a block's row as runs ``(level, li,
    length)``, each contiguous in one level: offset ``x`` lies in level
    ``floor(log2(x / B0 + 1))`` at ``li = x − B0·(2^level − 1)``."""
    runs, end = [], off + n
    while off < end:
        b = (off // b0 + 1).bit_length() - 1
        first = b0 * ((1 << b) - 1)
        length = min(first + (b0 << b), end) - off
        runs.append((b, off - first, length))
        off += length
    return runs
