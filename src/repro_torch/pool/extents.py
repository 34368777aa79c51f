"""Segmented pool extents: zero-copy growth via a two-level page table —
port of ``repro.pool.extents``.

The pool is a tuple of fixed-size **extents** plus a two-level mapping

    slab id  s  →  (extent id ``ext_of[s]``, offset-in-extent ``off_of[s]``)

so growth is "allocate one new extent and append a table row": existing
extents keep their device buffers (the same ``data_ptr()``), and **zero pool
bytes are ever copied** (Tarjan & Zwick, "Optimal resizable arrays").

Global slab ids stay the allocator's currency: ids are assigned in extent
order, so the concatenation of all extents *is* the flat pool, and every
plain version works on ``flat_data(pool)``.  The CUDA kernels resolve ids
through :func:`repro_torch.kernels.common.extent_table` — the extents' base
pointers and slab-id prefix, built on the host and cached per geometry.

Schedules (``grow_chunk``), plus the flat single-extent fallback:

``"doubling"``
    One new extent sized ``max(short, committed, 1)`` where ``committed``
    counts live + reserved slabs: **O(log n)** extents, at most half the
    pool wasted.

``"tz"``
    The Tarjan–Zwick optimal-block sequence: superblock ``k`` holds
    ``2^⌊k/2⌋`` extents of ``2^⌈k/2⌉`` slabs each (sizes 1, 2, 2, 2,
    4, 4, 4, 4, 4, 4, 8, …): **O(√n)** extents and O(√n) waste.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import device as _device

__all__ = [
    "ExtentPool",
    "EXTENT_SCHEDULES",
    "is_extent_schedule",
    "init_extent_pool",
    "grow_extents",
    "grow_flat",
    "plan_extents",
    "slab_tables",
    "resolve_pages",
    "flat_data",
]

EXTENT_SCHEDULES = ("doubling", "tz")


def is_extent_schedule(grow_chunk: Any) -> bool:
    """True when ``grow_chunk`` selects a zero-copy extent layout."""
    return isinstance(grow_chunk, str) and grow_chunk in EXTENT_SCHEDULES


@dataclasses.dataclass(frozen=True)
class ExtentPool:
    """The shared device pool as a tuple of extents + one free bitmap.

    ``extents[e]`` is ``(size_e, slab_size, *item_shape)``; slab ids are
    global (extent order), so ``free`` stays a single ``(n_slabs,)`` bitmap.
    """

    extents: tuple[torch.Tensor, ...]
    free: torch.Tensor  # (n_slabs,) bool — True = claimable

    @property
    def extent_sizes(self) -> tuple[int, ...]:
        return tuple(e.shape[0] for e in self.extents)

    @property
    def bases(self) -> tuple[int, ...]:
        """Global slab id of each extent's slab 0."""
        out, acc = [], 0
        for s in self.extent_sizes:
            out.append(acc)
            acc += s
        return tuple(out)

    @property
    def n_extents(self) -> int:
        return len(self.extents)

    @property
    def n_slabs(self) -> int:
        return sum(self.extent_sizes)

    @property
    def slab_size(self) -> int:
        return self.extents[0].shape[1]

    @property
    def item_shape(self) -> tuple[int, ...]:
        return tuple(self.extents[0].shape[2:])

    @property
    def dtype(self) -> torch.dtype:
        return self.extents[0].dtype

    @property
    def device(self) -> torch.device:
        return self.extents[0].device

    @property
    def capacity_tokens(self) -> int:
        return self.n_slabs * self.slab_size

    @property
    def data(self) -> torch.Tensor:
        """Flat (n_slabs, slab_size, *item) view — **copies** when multi-
        extent; plain versions and debugging only, never the hot path."""
        return flat_data(self.extents)


def init_extent_pool(
    n_slabs: int,
    slab_size: int,
    item_shape: Sequence[int] = (),
    dtype: torch.dtype = torch.float32,
    *,
    device: "str | torch.device | None" = None,
) -> ExtentPool:
    """Pre-carve the pool as one initial extent (possibly empty).
    ``device=None`` means the card."""
    dev = _device.resolve(device)
    return ExtentPool(
        extents=(torch.zeros((n_slabs, slab_size, *item_shape), dtype=dtype, device=dev),),
        free=torch.ones((n_slabs,), dtype=torch.bool, device=dev),
    )


def _tz_size(j: int) -> int:
    """Size of the ``j``-th data block in the Tarjan–Zwick sequence
    (1, 2, 2, 2, 4, 4, 4, 4, 4, 4, 8, …)."""
    k = 0
    while j >= 1 << (k // 2):
        j -= 1 << (k // 2)
        k += 1
    return 1 << ((k + 1) // 2)


def plan_extents(
    existing_sizes: Sequence[int],
    short: int,
    schedule: str,
    *,
    reserved: int = 0,
) -> list[int]:
    """Sizes of the new extent(s) covering ``short`` fresh slabs.

    ``reserved`` counts reserved-but-unclaimed slabs: the doubling schedule
    sizes off committed demand (``n_slabs + reserved``).  The tz sequence
    has fixed block sizes and ignores it.
    """
    if short <= 0:
        return []
    total = sum(existing_sizes)
    if schedule == "doubling":
        return [max(short, total + reserved, 1)]
    if schedule != "tz":
        raise ValueError(f"unknown extent schedule {schedule!r}")
    sizes: list[int] = []
    k = len([s for s in existing_sizes if s > 0])
    got = 0
    while got < short:
        step = _tz_size(k)
        sizes.append(step)
        got += step
        k += 1
    return sizes


def grow_extents(pool: ExtentPool, new_sizes: Sequence[int]) -> ExtentPool:
    """Append fresh zero extents — existing extents pass through **by
    identity** (same tensor objects, same ``data_ptr()``).

    Zero-size extents (an empty pre-carve) are dropped once a real extent
    exists; they hold no slab ids, so the global numbering is unchanged.
    """
    if not new_sizes:
        return pool
    T, item, dt, dev = pool.slab_size, pool.item_shape, pool.dtype, pool.device
    keep = tuple(e for e in pool.extents if e.shape[0] > 0)
    fresh = tuple(
        torch.zeros((s, T, *item), dtype=dt, device=dev) for s in new_sizes if s > 0
    )
    extra = sum(new_sizes)
    return ExtentPool(
        extents=(keep + fresh) or pool.extents,
        free=torch.cat([pool.free, torch.ones((extra,), dtype=torch.bool, device=dev)]),
    )


def grow_flat(pool: ExtentPool, extra: int) -> ExtentPool:
    """The realloc fallback: widen a single-extent pool by copy (the oracle
    and baseline for the extent schedules; O(log) copies under "geometric")."""
    if pool.n_extents != 1:
        raise ValueError("grow_flat requires a single-extent (flat) pool")
    data = pool.extents[0]
    return ExtentPool(
        extents=(
            torch.cat([data, torch.zeros((extra, *data.shape[1:]), dtype=data.dtype,
                                         device=data.device)]),
        ),
        free=torch.cat([pool.free, torch.ones((extra,), dtype=torch.bool, device=data.device)]),
    )


@lru_cache(maxsize=None)
def slab_tables(extent_sizes: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Host two-level table: global slab id → (extent id, offset-in-extent).

    Pure shape arithmetic — derived from the extent sizes, cached per
    geometry, never a device read.
    """
    ext = np.concatenate(
        [np.full((s,), e, np.int32) for e, s in enumerate(extent_sizes)]
        or [np.zeros((0,), np.int32)]
    )
    off = np.concatenate(
        [np.arange(s, dtype=np.int32) for s in extent_sizes]
        or [np.zeros((0,), np.int32)]
    )
    return ext, off


def resolve_pages(
    pages: torch.Tensor, extent_sizes: tuple[int, ...]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Resolve a page table of global slab ids through the two-level table.

    → ``(ext_tbl, off_tbl)`` int32 with the page table's shape; invalid ids
    (< 0, the unclaimed-page sentinel, or ≥ n_slabs) map to (−1, −1).
    """
    ext_np, off_np = slab_tables(tuple(extent_sizes))
    n = len(ext_np)
    pages = pages.to(torch.int32)
    valid = (pages >= 0) & (pages < n)
    idx = torch.clamp(pages, 0, max(n - 1, 0)).long()
    ext_t = torch.from_numpy(ext_np).to(pages.device)
    off_t = torch.from_numpy(off_np).to(pages.device)
    if n == 0:
        neg = torch.full_like(pages, -1)
        return neg, neg.clone()
    ext = torch.where(valid, ext_t[idx], -1)
    off = torch.where(valid, off_t[idx], -1)
    return ext, off


def flat_data(extents: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate extents into the flat pool (global-id order) — what every
    plain version reads; copies, so plain versions and debugging only."""
    extents = tuple(extents)
    if len(extents) == 1:
        return extents[0]
    return torch.cat(extents, dim=0)
