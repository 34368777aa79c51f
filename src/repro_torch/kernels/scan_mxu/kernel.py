"""K2 launcher: the tensor-core row scan (``csrc/scan_mxu.cu``).

Replaces ``repro/kernels/scan_mxu/kernel.py::row_scan_pallas``.  int32 is
exact (byte planes through u8 tensor-core products, bitwise equal to
``torch.cumsum``); f32 goes through split TF32.  One launch per call, a
chained single pass over tiles of :data:`TILE_ROWS` × :data:`TILE_COLS`:
each tile waits for its predecessor's row totals in 64-bit status words
and passes its own on.  The status words and the ticket counter the blocks
take their tiles from live here, one buffer of each per device, zeroed
once and left zeroed by every launch, so launches on one device must run in
stream order.  They cannot be made or grown inside a CUDA-graph capture
(the zero fill would only be recorded): a launch that would do so raises,
and one eager launch at the captured shape, or :func:`scan_buffers`, before
the capture makes them.

The plan in Python, replayed by ``tests/test_torch_freeze_plan.py``:
:func:`scan_plan`, :func:`ticket_tile` and :func:`chain_replay`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build, common

__all__ = ["row_scan_mxu_cuda", "scan_buffers", "scan_plan", "ticket_tile", "chain_replay",
           "ScanPlan", "DTYPES", "TILE_ROWS", "TILE_COLS", "STATUS0"]

DTYPES = {torch.int32: 0, torch.float32: 1}
TILE_ROWS = 16  # the products' m (kTileRows)
TILE_COLS = 1024  # kTileCols: 8 warps x 4 chunks of 32 columns
WARP_COLS = 128  # columns a warp scans (kChunks chunks of 32)
STATUS0 = 1024  # the status buffer's first size, in 64-bit words

_c = ctypes.c_void_p
_i64 = ctypes.c_int64
_status: dict[torch.device, torch.Tensor] = {}
_tickets: dict[torch.device, torch.Tensor] = {}
# buffers replaced by a larger one stay alive: a captured CUDA graph may
# still launch with them
_retired: list[torch.Tensor] = []


def _lib():
    lib = _build.library("scan_mxu")
    lib.rt_row_scan_mxu.argtypes = [_c, _c, _c, _c, ctypes.c_int, _i64, _i64, _c]
    lib.rt_row_scan_mxu.restype = ctypes.c_int
    lib.rt_scan_mxu_tile_cols.argtypes = []
    lib.rt_scan_mxu_tile_cols.restype = _i64
    if lib.rt_scan_mxu_tile_cols() != TILE_COLS:
        raise RuntimeError("row_scan_mxu: the library's tile width differs from TILE_COLS")
    return lib


class ScanPlan(NamedTuple):
    groups: int  # row groups of TILE_ROWS rows
    tiles: int  # column tiles of TILE_COLS columns a row group
    status_words: int  # one per (row group, tile boundary, row)


def scan_plan(rows: int, cols: int) -> ScanPlan:
    """The launch's tiles (one block each) and the status words it uses."""
    groups, tiles = -(-rows // TILE_ROWS), -(-cols // TILE_COLS)
    return ScanPlan(groups, tiles, groups * max(tiles - 1, 0) * TILE_ROWS)


def ticket_tile(ticket: int, groups: int) -> tuple[int, int]:
    """The (row group, column tile) a block scans with ``ticket``."""
    return ticket % groups, ticket // groups


def scan_buffers(dev: torch.device, status_words: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The device's status buffer (at least ``status_words`` int64 zeros)
    and its ticket counter (one int32 zero)."""
    status = common.device_buffer(_status, _retired, dev, status_words, torch.int64, first=STATUS0,
                                  zero=True, what="row_scan_mxu status words")
    ticket = common.device_buffer(_tickets, _retired, dev, 1, torch.int32, first=1, zero=True,
                                  what="row_scan_mxu ticket")
    return status, ticket


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
    status, ticket = scan_buffers(x.device, scan_plan(rows, cols).status_words)
    with torch.cuda.device(x.device):
        rc = lib.rt_row_scan_mxu(
            x.data_ptr(), out.data_ptr(), status.data_ptr(), ticket.data_ptr(),
            DTYPES[x.dtype], rows, cols, common.stream_of(x.device),
        )
    common.check_status(rc, lib, "row_scan_mxu")
    common.count_launch("row_scan_mxu")
    return out


def chain_replay(x: np.ndarray, order: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """The int32 kernel's arithmetic in numpy, its tiles completing in
    ``order`` (a permutation of the tickets; a tile whose predecessor has
    not published yet waits, and the next tile of ``order`` that can go
    goes) → (output, the status words after the launch, the ticket counter
    after it).  Per tile: each warp's span scanned and carried across its
    chunks, the warps' totals summed in warp order, the predecessor's
    status word read and zeroed, the tile's own published unless it is the
    last of its rows, and the carry added; all modulo 2^32."""
    rows, cols = x.shape
    plan = scan_plan(rows, cols)
    pad = np.zeros((plan.groups * TILE_ROWS, plan.tiles * TILE_COLS), np.uint64)
    pad[:rows, :cols] = x.astype(np.int64).astype(np.uint64) & 0xFFFFFFFF
    status = np.zeros(max(plan.status_words, 1), np.uint64)
    ready = np.uint64(1 << 32)
    low = np.uint64(0xFFFFFFFF)
    out = np.zeros_like(pad)
    counter = 0
    local = {}
    for ticket in range(plan.groups * plan.tiles):  # the blocks take their tickets
        counter = 0 if ticket == plan.groups * plan.tiles - 1 else ticket + 1  # atomicAdd; the last resets
        g, c = ticket_tile(ticket, plan.groups)
        tile = pad[g * TILE_ROWS:(g + 1) * TILE_ROWS, c * TILE_COLS:(c + 1) * TILE_COLS]
        warps = tile.reshape(TILE_ROWS, -1, WARP_COLS)
        scan = np.cumsum(warps, axis=2) & low
        totals = scan[:, :, -1]
        pre = (np.cumsum(totals, axis=1) - totals) & low
        local[ticket] = ((scan + pre[:, :, None]) & low).reshape(TILE_ROWS, -1), totals.sum(1) & low
    pending = list(order)
    while pending:
        for k, ticket in enumerate(pending):
            g, c = ticket_tile(ticket, plan.groups)
            words = g * (plan.tiles - 1) * TILE_ROWS
            prev = slice(words + (c - 1) * TILE_ROWS, words + c * TILE_ROWS)
            if c == 0 or np.all(status[prev] & ready):
                break
        else:
            raise RuntimeError("chain_replay: no tile can go (a cycle in the chain)")
        pending.pop(k)
        scan, total = local[ticket]
        carry = np.zeros(TILE_ROWS, np.uint64)
        if c > 0:
            carry = status[prev] & low
            status[prev] = 0
        if c + 1 < plan.tiles:
            status[words + c * TILE_ROWS:words + (c + 1) * TILE_ROWS] = ready | ((carry + total) & low)
        out[g * TILE_ROWS:(g + 1) * TILE_ROWS, c * TILE_COLS:(c + 1) * TILE_COLS] = \
            (scan + carry[:, None]) & low
    return out[:rows, :cols].astype(np.uint32).view(np.int32), status[:plan.status_words], counter
