"""Bucket geometry + global indexing for GGArray (port of ``repro.core.indexing``).

Bucket ``b`` of an LFVector holds ``B0 * 2**b`` elements, so the first ``nb``
buckets cover in-block positions ``[0, B0*(2**nb - 1))``.  Growth appends the
next bucket; existing buckets never move.  A prefix sum over per-block sizes
gives the first global index each block owns, and a binary search over it
finds the block that owns a global index (paper §IV).
"""
from __future__ import annotations

import torch

__all__ = [
    "bucket_sizes",
    "bucket_starts",
    "capacity",
    "bucket_of_position",
    "local_offset",
    "block_starts",
    "find_block",
    "min_buckets_for",
]


def bucket_sizes(b0: int, nbuckets: int) -> tuple[int, ...]:
    """Size of each bucket level: ``B0 * 2**b`` (paper Alg. 2)."""
    return tuple(b0 * (1 << b) for b in range(nbuckets))


def bucket_starts(b0: int, nbuckets: int) -> tuple[int, ...]:
    """First in-block position covered by each bucket: ``B0*(2**b - 1)``."""
    return tuple(b0 * ((1 << b) - 1) for b in range(nbuckets))


def capacity(b0: int, nbuckets: int) -> int:
    """Total per-block capacity with ``nbuckets`` levels: ``B0*(2**nb - 1)``."""
    return b0 * ((1 << nbuckets) - 1)


def min_buckets_for(b0: int, n: int) -> int:
    """Smallest number of bucket levels whose capacity holds ``n`` elements."""
    nb = 0
    while capacity(b0, nb) < n:
        nb += 1
    return nb


def bucket_of_position(pos: torch.Tensor, b0: int, nbuckets: int) -> torch.Tensor:
    """Bucket level that owns in-block position ``pos`` (exact integer compares)."""
    starts = bucket_starts(b0, nbuckets)
    level = torch.zeros(pos.shape, dtype=torch.int32, device=pos.device)
    for b in range(1, nbuckets):
        level += (pos >= starts[b]).to(torch.int32)
    return level


def local_offset(
    pos: torch.Tensor, level: torch.Tensor, b0: int, nbuckets: int
) -> torch.Tensor:
    """Offset of in-block position ``pos`` inside its bucket ``level``."""
    starts = torch.tensor(bucket_starts(b0, nbuckets), dtype=torch.int32,
                          device=pos.device)
    return pos.to(torch.int32) - starts[level.long()]


def block_starts(sizes: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of per-block sizes — the paper's global index table."""
    return torch.cumsum(sizes, 0, dtype=sizes.dtype) - sizes


def find_block(starts: torch.Tensor, global_idx: torch.Tensor) -> torch.Tensor:
    """Binary search (paper §IV): block owning ``global_idx`` given start table.

    An upper-bound search: the owner is (the number of starts ≤ idx) − 1, so
    empty blocks, which share their start with the next block, never own.
    """
    idx = global_idx.to(starts.dtype)
    return (torch.searchsorted(starts, idx, right=True).to(torch.int32) - 1).clamp(min=0)
