"""Flatten wrappers: compaction (K6) + global ordering (K7) — port of ``flatten/ops.py``.

``flatten(..., impl="segmented")`` (the default, the freeze path) orders
the bucket levels' live items block-major by the ``block_starts`` prefix
table — O(n).  The reference compacts the levels into ``(nblocks, cap)``
rows first; on the card K7 reads the levels directly (its levels form), so
no plane is written or read.  ``impl="dispatch"`` is the reference's legacy
ordering: compaction (K6), then the dispatch scatter (K5a) of every live
element to its global position.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels or
raises.  ``memory_space`` selects a TPU tiling in the reference; it is
checked and has no effect here.  ``instrument=True`` (the device counter
plane, K15) adds a float32 counter vector to the output: K7's in-kernel
counts (launch, rows touched) plus ``flatten.span_rows`` = Σ sizes, or
their plain twin (``ref.gather_counters``) on the CPU.  The legacy
``"dispatch"`` ordering has no in-kernel count and reports the launch and
the span, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.core import indexing
from repro_torch.kernels import common
from repro_torch.kernels.flatten import kernel as _kernel
from repro_torch.kernels.flatten import ref as _ref
from repro_torch.obs import device as obs_device

__all__ = ["compact_blocks", "segmented_gather", "flatten", "flatten_segmented", "flatten_dispatch"]

def compact_blocks(
    levels: tuple[torch.Tensor, ...], b0: int, *, memory_space: str | None = None
) -> torch.Tensor:
    """Bucket levels of scalar items → ``(nblocks, cap)`` rows."""
    common.check_memory_space(memory_space)
    if common.on_cpu(levels[0]):
        return _ref.compact_blocks(levels, b0)
    return common.run_kernel("compact_blocks", list(levels), lambda: _ref.compact_blocks(levels, b0),
                             lambda: _kernel.compact_blocks_cuda(levels, b0))


def segmented_gather(
    compact: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor, *, instrument: bool = False
):
    """``(nblocks, cap)`` rows of scalar items + int32 starts/ends → block-major
    ``(nblocks·cap,)`` order (K7); the arena's flatten calls it directly.
    ``instrument=True`` → (out, counter vector)."""
    def plain():
        out = _ref.gather_global(compact, starts, ends)
        if instrument:
            return out, _ref.gather_counters(starts, ends, *compact.shape)
        return out

    if common.on_cpu(compact):
        return plain()
    return common.run_kernel(
        "segmented_gather", [compact, starts, ends], plain,
        lambda: _with_span(_kernel.segmented_gather_cuda(compact, starts, ends, instrument=instrument),
                           starts, ends, instrument))


def _with_span(launched, starts: torch.Tensor, ends: torch.Tensor, instrument: bool):
    """K7's output, or (output, its counters + ``flatten.span_rows``)."""
    if not instrument:
        return launched
    out, block = launched
    span = (ends.to(torch.int64) - starts.to(torch.int64)).sum()
    return out, obs_device.from_block(block) + obs_device.pack(**{"flatten.span_rows": span})


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
    instrument: bool = False,
):
    """GGArray flatten: the linear-time segmented gather of the levels' live
    items → ``(nblocks·cap,)`` (and the counter vector with ``instrument``).
    On the card one K7 launch reads the levels (no K6)."""
    common.check_memory_space(memory_space)
    starts, ends = _prefix_tables(sizes)
    def plain():
        out = _ref.gather_levels(levels, b0, starts, ends)
        if instrument:
            return out, _ref.gather_counters(starts, ends, levels[0].shape[0],
                                             indexing.capacity(b0, len(levels)))
        return out

    if common.on_cpu(levels[0]):
        return plain()
    return common.run_kernel(
        "segmented_gather", [*levels, starts, ends], plain,
        lambda: _with_span(
            _kernel.segmented_gather_levels_cuda(levels, b0, starts, ends, instrument=instrument),
            starts, ends, instrument))


def flatten_dispatch(
    levels: tuple[torch.Tensor, ...],
    sizes: torch.Tensor,
    b0: int,
    *,
    memory_space: str | None = None,
) -> torch.Tensor:
    """GGArray flatten: compact (K6) + dispatch scatter (K5a, legacy)."""
    from repro_torch.kernels.dispatch_mxu import ops as dispatch_ops

    compact = compact_blocks(levels, b0, memory_space=memory_space)
    nblocks, cap = compact.shape
    sizes = sizes.to(torch.int32)
    starts = indexing.block_starts(sizes)
    posn = torch.arange(cap, dtype=torch.int32, device=compact.device)[None, :]
    live = posn < sizes[:, None]
    pos = torch.where(live, starts[:, None] + posn, -1).reshape(-1)
    return dispatch_ops.dispatch(compact.reshape(-1, 1), pos, nblocks * cap)[:, 0]


def flatten(
    levels: tuple[torch.Tensor, ...],
    sizes: torch.Tensor,
    b0: int,
    *,
    impl: str = "segmented",
    memory_space: str | None = None,
    instrument: bool = False,
):
    """Full GGArray flatten on kernels → ``(nblocks·cap,)`` block-major order
    (and the counter vector with ``instrument``)."""
    if impl == "segmented":
        return flatten_segmented(levels, sizes, b0, memory_space=memory_space,
                                 instrument=instrument)
    if impl == "dispatch":
        out = flatten_dispatch(levels, sizes, b0, memory_space=memory_space)
        if not instrument:
            return out
        return out, obs_device.pack(out.device, **{
            "flatten.launches": 1,
            "flatten.span_rows": sizes.to(torch.int64).sum(),
        })
    raise ValueError(f"unknown flatten impl {impl!r} (want 'segmented'|'dispatch')")
