"""Plain PyTorch version of the fused push-back (K3) — port of ``push_back/ref.py``.

The scan-then-scatter path on raw bucket tuples: exclusive prefix sum of the
mask, then one drop-scatter per bucket level (``common.scatter_levels_``:
lanes masked out or past the last level write nothing, and nothing reads
the device on the host).  Like the kernel it writes ``levels`` in place.
"""
from __future__ import annotations

import torch

from repro_torch.core import indexing
from repro_torch.kernels import common
from repro_torch.obs import device as obs_device

__all__ = ["push_back", "counters"]


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


def counters(mask: torch.Tensor, sizes: torch.Tensor, b0: int, nlevels: int) -> torch.Tensor:
    """The plain twin of K3's counter block, as a float32 vector — port of
    ``_oracle_counters`` (``push_back/ops.py:42``) over the card's own lanes:
    ``lanes`` = nblocks·m, no padded lanes, and ``level_writes`` the write
    interval ``[size, size + count)`` clipped to each level."""
    nblocks, m = mask.shape
    dev = mask.device
    starts = torch.tensor(indexing.bucket_starts(b0, nlevels), dtype=torch.int64)
    ends = starts + torch.tensor(indexing.bucket_sizes(b0, nlevels), dtype=torch.int64)
    count = mask.to(torch.int64).sum(1)
    lo = torch.maximum(sizes.to(torch.int64)[:, None], starts.to(dev)[None, :])
    hi = torch.minimum((sizes.to(torch.int64) + count)[:, None], ends.to(dev)[None, :])
    return obs_device.pack(dev, **{
        "push_back.waves": 1,
        "push_back.lanes": nblocks * m,
        "push_back.active_lanes": count.sum(),
        "push_back.level_writes": torch.clamp(hi - lo, min=0).sum(),
    })
