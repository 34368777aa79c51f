"""Plain PyTorch version of the fused push-back (K3) — port of ``push_back/ref.py``.

The scan-then-scatter path on raw bucket tuples: exclusive prefix sum of the
mask, then one drop-scatter per bucket level (``common.scatter_levels_``:
lanes masked out or past the last level write nothing, and nothing reads
the device on the host).  Like the kernel it writes ``levels`` in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common

__all__ = ["push_back"]


def push_back(
    levels: tuple[torch.Tensor, ...],  # level b: (nblocks, B0·2^b, *item)
    sizes: torch.Tensor,  # (nblocks,) int32
    b0: int,
    elems: torch.Tensor,  # (nblocks, m, *item)
    mask: torch.Tensor,  # (nblocks, m) bool
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """→ (levels written in place, new sizes, positions (−1 where masked out))."""
    mask_i = mask.to(torch.int32)
    inclusive = torch.cumsum(mask_i, dim=-1, dtype=torch.int32)
    offsets = inclusive - mask_i
    m = mask.shape[1]
    counts = inclusive[:, -1] if m else torch.zeros_like(sizes)
    pos = sizes.to(torch.int32)[:, None] + offsets
    common.scatter_levels_(levels, b0, pos, mask, elems)
    return levels, sizes + counts, torch.where(mask, pos, -1)
