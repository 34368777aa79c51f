"""Plain reference of the §VI job's result: what the frozen array must hold
after the waves were inserted and the regular phase ran.

Wave ``w`` offers ``nblocks × m_w`` lanes, row-major, of which those whose
flat index is below the wave's size are masked in; block ``b`` therefore
takes ``clamp(size_w − b·m_w, 0, m_w)`` of its row.  The frozen order is
block-major: block 0's inserted elements wave after wave, then block 1's,
and so on; each element then gets ``+1`` ``repeats`` times in the array's
dtype, and every slot past the live count stays zero.
"""
from __future__ import annotations

import torch


def block_counts(sizes: list[int], nblocks: int) -> list[list[int]]:
    """counts[w][b]: lanes of wave ``w`` that block ``b`` inserts."""
    out = []
    for size in sizes:
        m = -(-size // nblocks)
        out.append([max(0, min(m, size - b * m)) for b in range(nblocks)])
    return out


def _block_values(waves: list[torch.Tensor], counts: list[list[int]], b: int, repeats: int,
                  dtype: torch.dtype) -> torch.Tensor:
    want = torch.cat([waves[w][b, :counts[w][b]] for w in range(len(waves))]).to(dtype)
    for _ in range(repeats):
        want = want + 1
    return want


def frozen_mismatches(data: torch.Tensor, waves: list[torch.Tensor], sizes: list[int], repeats: int) -> dict:
    """Compare a frozen buffer with the rebuilt order, one block at a time,
    in the waves' dtype.  ``waves[w]`` is the (nblocks, m_w) tensor offered
    in wave ``w``.  → mismatched live elements, nonzero tail elements, and
    the live count the reference expects."""
    nblocks = waves[0].shape[0]
    counts = block_counts(sizes, nblocks)
    bad = torch.zeros((), dtype=torch.int64, device=data.device)
    start = 0
    for b in range(nblocks):
        want = _block_values(waves, counts, b, repeats, waves[0].dtype)
        n_b = want.shape[0]
        got = data[start:start + n_b]
        if got.shape[0] < n_b:  # the buffer ends early: every missing element is wrong
            bad += n_b - got.shape[0]
            want = want[:got.shape[0]]
        bad += (got != want).sum()
        start += n_b
    tail = torch.count_nonzero(data[start:]) if data.shape[0] > start else torch.zeros((), device=data.device)
    return {"mismatches": int(bad.item()), "tail_nonzero": int(tail.item()), "expected_elements": start}


def rebuild(waves: list[torch.Tensor], sizes: list[int], repeats: int, capacity: int,
            dtype: torch.dtype) -> torch.Tensor:
    """The whole frozen buffer as the reference builds it, with the values
    computed in ``dtype`` and stored in the waves' dtype (``dtype`` below
    theirs is the control)."""
    nblocks = waves[0].shape[0]
    counts = block_counts(sizes, nblocks)
    out = torch.zeros((capacity,), dtype=waves[0].dtype, device=waves[0].device)
    start = 0
    for b in range(nblocks):
        want = _block_values(waves, counts, b, repeats, dtype)
        out[start:start + want.shape[0]] = want.to(out.dtype)
        start += want.shape[0]
    return out
