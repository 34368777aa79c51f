"""Plain PyTorch versions of the flatten kernels (K6, K7) — port of ``flatten/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.core import indexing
from repro_torch.kernels import common

__all__ = ["compact_blocks", "flatten_global", "gather_global", "dispatch"]


def compact_blocks(levels: tuple[torch.Tensor, ...], b0: int) -> torch.Tensor:
    """(levels of (nblocks, size_b)) → (nblocks, capacity) row-major."""
    return torch.cat(levels, dim=1)


def flatten_global(compact: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Row-compacted (nblocks, cap) → block-major global order (nblocks·cap,)."""
    nblocks, cap = compact.shape
    starts = indexing.block_starts(sizes)
    posn = torch.arange(cap, dtype=torch.int32, device=compact.device)[None, :]
    live = posn < sizes[:, None]
    tgt = starts[:, None] + posn
    out = torch.zeros((nblocks * cap,), dtype=compact.dtype, device=compact.device)
    return common.put_drop_(out, (tgt,), live & (tgt < nblocks * cap), compact)


def gather_global(
    compact: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor
) -> torch.Tensor:
    """Gather form of the segmented kernel (same index math as K7).

    The owner of output ``i`` is (the number of ``starts`` ≤ ``i``) − 1, an
    upper-bound search; ``starts`` is non-decreasing from 0.
    """
    nblocks, cap = compact.shape
    idx = torch.arange(nblocks * cap, dtype=torch.int64, device=compact.device)
    blk = (torch.searchsorted(starts.to(torch.int64), idx, right=True) - 1).clamp(min=0)
    pos = idx - starts.to(torch.int64)[blk]
    live = idx < ends.to(torch.int64)[blk]
    vals = compact.reshape(-1)[blk * cap + torch.clamp(pos, max=cap - 1)]
    return torch.where(live, vals, torch.zeros_like(vals))


def dispatch(vals: torch.Tensor, slots: torch.Tensor, nslots: int) -> torch.Tensor:
    """Plain version of the reference's dispatch kernel (K5):
    ``out[slots[t]] += vals[t]`` into ``(nslots, D)`` zeros, dropping slots
    outside ``[0, nslots)``.  A dropped lane adds zeros to slot 0."""
    keep = (slots >= 0) & (slots < nslots)
    out = torch.zeros((nslots, *vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    src = torch.where(keep.reshape(-1, *(1,) * (vals.ndim - 1)), vals, torch.zeros_like(vals))
    return out.index_add_(0, torch.where(keep, slots, 0).to(torch.int64), src)
