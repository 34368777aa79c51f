"""Comparison structures from the paper (§III.A): static and semi-static
arrays — port of ``repro.core.baselines``.

``StaticArray``
    Flat pre-allocated buffer (cudaMalloc at start).  Insertions run on the
    device with the same parallel insertion algorithms (``scan``, ``tile``
    = K1, ``mxu`` = K2, ``atomic``); there is no resize, so the caller sizes
    it for the worst case.  Writes past the capacity are dropped.

``SemiStaticArray``
    Flat buffer resized from the host by doubling.  ``copy_on_grow=True`` is
    classic realloc (allocate 2x, copy everything).  The paper's ``memMap``
    variant remaps pages with the CUDA virtual-memory API so growth skips the
    copy; the reference models it by timing the allocation alone
    (``grow_alloc_only``) while the copy still happens, untimed, for
    correctness.  The port keeps that accounting.

**In place.**  The reference's ``static_push_back`` returns a new buffer (not
donated, so XLA copies it).  Here it writes ``arr.data`` in place and
returns the array with its new ``size`` — a static array's point is that an
insertion touches only the inserted slots.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core.insertion import insertion_offsets
from repro_torch.kernels.common import put_drop_, to_device

__all__ = ["StaticArray", "SemiStaticArray", "static_init", "static_push_back"]


@dataclasses.dataclass(frozen=True)
class StaticArray:
    data: torch.Tensor  # (capacity, *item_shape)
    size: torch.Tensor  # () int32, on the device

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


def static_init(
    capacity: int,
    item_shape: Sequence[int] = (),
    dtype: torch.dtype = torch.float32,
    *,
    device: "str | torch.device | None" = None,
) -> StaticArray:
    """Zeroed buffer of ``capacity`` items; ``device=None`` means the card."""
    dev = _device.resolve(device)
    return StaticArray(
        data=torch.zeros((capacity, *item_shape), dtype=dtype, device=dev),
        size=torch.zeros((), dtype=torch.int32, device=dev),
    )


def static_push_back(
    arr: StaticArray,
    elems: Any,
    mask: Any = None,
    method: str = "scan",
) -> tuple[StaticArray, torch.Tensor]:
    """Parallel insertion into a flat array (one global index space) →
    (array with the new size, positions with −1 where masked out).  Writes
    ``arr.data`` in place; no host sync."""
    dev = arr.data.device
    elems = to_device(elems, dev).to(arr.data.dtype)
    if mask is None:
        mask = torch.ones(elems.shape[:1], dtype=torch.bool, device=dev)
    mask = to_device(mask, dev)
    offsets, count = insertion_offsets(mask[None], method=method)
    mask = mask != 0
    pos = arr.size + offsets[0]
    put_drop_(arr.data, (pos,), mask & (pos < arr.capacity), elems)
    return StaticArray(data=arr.data, size=arr.size + count[0]), torch.where(mask, pos, -1)


@dataclasses.dataclass
class SemiStaticArray:
    """Host-resizable flat array (doubling): the paper's semi-static/memMap."""

    arr: StaticArray
    copy_on_grow: bool = True  # False: memMap accounting (module docstring)

    @classmethod
    def create(
        cls,
        capacity: int,
        item_shape: Sequence[int] = (),
        dtype: torch.dtype = torch.float32,
        copy_on_grow: bool = True,
        *,
        device: "str | torch.device | None" = None,
    ) -> "SemiStaticArray":
        return cls(static_init(capacity, item_shape, dtype, device=device), copy_on_grow)

    @property
    def capacity(self) -> int:
        return self.arr.capacity

    @property
    def size(self) -> int:
        """The element count — one device read."""
        return int(self.arr.size.item())

    # -- host-driven growth (the paper's host-synchronised resize) -------
    def grow_alloc_only(self) -> torch.Tensor:
        """Allocate the doubled buffer (the part memMap pays for)."""
        d = self.arr.data
        return torch.zeros((d.shape[0] * 2, *d.shape[1:]), dtype=d.dtype, device=d.device)

    def grow(self) -> None:
        """Double the capacity.  realloc copies; memMap remaps (its copy
        happens here too, untimed by the harness)."""
        new = self.grow_alloc_only()
        new[: self.capacity] = self.arr.data
        self.arr = StaticArray(data=new, size=self.arr.size)

    def ensure_capacity(self, n_new: int) -> int:
        """Grow until ``n_new`` more fit → the number of doublings done."""
        grows = 0
        while self.size + n_new > self.capacity:
            self.grow()
            grows += 1
        return grows

    def push_back(self, elems: Any, mask: Any = None, method: str = "scan") -> torch.Tensor:
        self.ensure_capacity(len(elems))
        self.arr, pos = static_push_back(self.arr, elems, mask, method=method)
        return pos
