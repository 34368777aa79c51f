"""Parallel insertion-index algorithms (paper §III.B) — port of ``repro.core.insertion``.

Given an insertion mask per block, every inserting lane gets a unique, dense
offset: the **exclusive prefix sum of the mask along the element axis**.

``atomic``
    The serialized counter (CUDA ``atomicAdd`` in the paper; a
    column-by-column loop here, as the reference's ``fori_loop``).  Kept, as
    in the paper, as the deliberately slow baseline.
``scan``
    ``torch.cumsum`` — plain PyTorch, as the reference computes it outside
    Pallas.
``tile``
    The hand-written row-scan kernel K1 (``kernels/scan_tile``).
``mxu``
    The tensor-core matmul scan K2 (``kernels/scan_mxu``): byte planes of the
    int32 mask through u8 tensor-core products, bitwise equal to ``scan``.

All functions take ``mask: (nblocks, m) bool`` and return ``(offsets,
counts)``: ``offsets (nblocks, m) int32`` (valid where ``mask``) and
``counts (nblocks,) int32``.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["insertion_offsets", "INSERTION_METHODS"]


def _offsets_atomic(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Serialized counter — the ``atomicAdd`` analog (slowest, as in the paper)."""
    nblocks, m = mask.shape
    mask_i = mask.to(torch.int32)
    counter = torch.zeros((nblocks,), dtype=torch.int32, device=mask.device)
    offsets = torch.zeros((nblocks, m), dtype=torch.int32, device=mask.device)
    for j in range(m):
        offsets[:, j] = counter
        counter = counter + mask_i[:, j]
    return offsets, counter


def _offsets_scan(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain ``cumsum`` scan — the warp-shuffle analog (fastest in the paper)."""
    mask_i = mask.to(torch.int32)
    inclusive = torch.cumsum(mask_i, dim=-1, dtype=torch.int32)
    return inclusive - mask_i, inclusive[:, -1]


def _offsets_mxu(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tensor-core matmul scan (K2) — the paper's tensor-core analog."""
    from repro_torch.kernels.scan_mxu import ops as scan_mxu_ops

    mask_i = mask.to(torch.int32)
    inclusive = scan_mxu_ops.row_scan(mask_i)
    return inclusive - mask_i, inclusive[:, -1]


def _offsets_tile(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hand-written tile scan (K1)."""
    from repro_torch.kernels.scan_tile import ops as scan_tile_ops

    mask_i = mask.to(torch.int32)
    inclusive = scan_tile_ops.row_scan(mask_i)
    return inclusive - mask_i, inclusive[:, -1]


INSERTION_METHODS: dict[str, Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]] = {
    "atomic": _offsets_atomic,
    "scan": _offsets_scan,
    "mxu": _offsets_mxu,
    "tile": _offsets_tile,
}


def insertion_offsets(
    mask: torch.Tensor, method: str = "scan"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exclusive per-block insertion offsets + per-block insert counts.

    ``mask`` may be bool or any integer dtype; it is normalized to bool
    (``!= 0``) first — every backend counts *lanes*, not values.  Float
    masks are rejected.
    """
    if mask.ndim != 2:
        raise ValueError(f"mask must be (nblocks, m), got {tuple(mask.shape)}")
    if mask.dtype.is_floating_point or mask.dtype.is_complex:
        raise TypeError(f"mask must be bool or integer, got {mask.dtype}")
    if mask.dtype != torch.bool:
        mask = mask != 0
    try:
        fn = INSERTION_METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown insertion method {method!r}; options: {sorted(INSERTION_METHODS)}"
        ) from None
    if mask.shape[1] == 0:  # empty wave: no offsets, zero counts
        nblocks = mask.shape[0]
        return (
            torch.zeros((nblocks, 0), dtype=torch.int32, device=mask.device),
            torch.zeros((nblocks,), dtype=torch.int32, device=mask.device),
        )
    return fn(mask)
