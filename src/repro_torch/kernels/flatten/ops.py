"""Flatten wrappers: compaction (K6) + global ordering (K7) — port of ``flatten/ops.py``.

``flatten(..., impl="segmented")`` (the default, the freeze path) compacts
the bucket levels into ``(nblocks, cap)`` rows and orders them block-major
by the ``block_starts`` prefix table — O(n).  ``impl="dispatch"`` is the
reference's legacy one-hot dispatch ordering (K5): its plain version runs on
the CPU, and on a CUDA device it raises until K5 is ported (ROADMAP.md).

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels or
raises.  ``memory_space`` selects a TPU tiling in the reference; it is
checked and has no effect here.
"""
from __future__ import annotations

import torch

from repro_torch.core import indexing
from repro_torch.kernels import common
from repro_torch.kernels.flatten import kernel as _kernel
from repro_torch.kernels.flatten import ref as _ref

__all__ = ["compact_blocks", "flatten", "flatten_segmented", "flatten_dispatch"]

def compact_blocks(
    levels: tuple[torch.Tensor, ...], b0: int, *, memory_space: str | None = None
) -> torch.Tensor:
    """Bucket levels of scalar items → ``(nblocks, cap)`` rows."""
    common.check_memory_space(memory_space)
    if levels[0].device.type == "cpu":
        return _ref.compact_blocks(levels, b0)
    return _kernel.compact_blocks_cuda(levels, b0)


def _prefix_tables(sizes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    sizes = sizes.to(torch.int32)
    starts = indexing.block_starts(sizes)
    return starts, starts + sizes


def flatten_segmented(
    levels: tuple[torch.Tensor, ...],
    sizes: torch.Tensor,
    b0: int,
    *,
    memory_space: str | None = None,
) -> torch.Tensor:
    """GGArray flatten: compact + linear-time segmented gather → ``(nblocks·cap,)``."""
    compact = compact_blocks(levels, b0, memory_space=memory_space)
    starts, ends = _prefix_tables(sizes)
    if compact.device.type == "cpu":
        return _ref.gather_global(compact, starts, ends)
    return _kernel.segmented_gather_cuda(compact, starts, ends)


def flatten_dispatch(
    levels: tuple[torch.Tensor, ...],
    sizes: torch.Tensor,
    b0: int,
    *,
    memory_space: str | None = None,
) -> torch.Tensor:
    """GGArray flatten: compact + one-hot dispatch scatter (legacy, K5)."""
    if levels[0].device.type != "cpu":
        raise NotImplementedError(
            "flatten(impl='dispatch') needs K5 (dispatch_mxu), not ported to "
            "CUDA yet (ROADMAP.md, Queue 2); use impl='segmented'"
        )
    compact = compact_blocks(levels, b0, memory_space=memory_space)
    nblocks, cap = compact.shape
    starts = indexing.block_starts(sizes)
    posn = torch.arange(cap, dtype=torch.int32)[None, :]
    live = posn < sizes[:, None]
    pos = torch.where(live, starts[:, None] + posn, -1).reshape(-1)
    return _ref.dispatch(compact.reshape(-1, 1), pos, nblocks * cap)[:, 0]


def flatten(
    levels: tuple[torch.Tensor, ...],
    sizes: torch.Tensor,
    b0: int,
    *,
    impl: str = "segmented",
    memory_space: str | None = None,
) -> torch.Tensor:
    """Full GGArray flatten on kernels → ``(nblocks·cap,)`` block-major order."""
    if impl == "segmented":
        return flatten_segmented(levels, sizes, b0, memory_space=memory_space)
    if impl == "dispatch":
        return flatten_dispatch(levels, sizes, b0, memory_space=memory_space)
    raise ValueError(f"unknown flatten impl {impl!r} (want 'segmented'|'dispatch')")
