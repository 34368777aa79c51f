"""Plain PyTorch versions of the flatten kernels (K6, K7) — port of ``flatten/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.core import indexing
from repro_torch.kernels import common
from repro_torch.obs import device as obs_device

__all__ = ["compact_blocks", "flatten_global", "gather_global", "gather_levels", "gather_counters"]

SEG_TILE = 256  # the reference's DEFAULT_SEG_TILE: the counters' tile


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


def gather_levels(
    levels: tuple[torch.Tensor, ...], b0: int, starts: torch.Tensor, ends: torch.Tensor
) -> torch.Tensor:
    """The plain version of K7's levels form: :func:`gather_global` of the
    levels' compaction (K6's plain version)."""
    return gather_global(compact_blocks(levels, b0), starts, ends)


def gather_counters(starts: torch.Tensor, ends: torch.Tensor, nblocks: int, cap: int) -> torch.Tensor:
    """The plain twin of K7's counters, as a float32 vector — port of
    ``_seg_ctr_oracle`` (``flatten/ops.py:36``): over the 256-element tiles
    of the ``nblocks·cap`` output (the tail tile too), Σ (hi − lo) with
    lo = max(#{starts ≤ t0} − 1, 0), hi = #{starts ≤ t0 + 255}; plus the
    launch and ``span_rows`` = Σ (ends − starts)."""
    dev = starts.device
    ntiles = -(-(nblocks * cap) // SEG_TILE)
    t0 = torch.arange(ntiles, dtype=torch.int64, device=dev) * SEG_TILE
    st = starts.to(torch.int64)
    lo = (torch.searchsorted(st, t0, right=True) - 1).clamp(min=0)
    hi = torch.searchsorted(st, t0 + SEG_TILE - 1, right=True)
    return obs_device.pack(dev, **{
        "flatten.launches": 1,
        "flatten.rows_touched": (hi - lo).sum(),
        "flatten.span_rows": (ends.to(torch.int64) - st).sum(),
    })
