"""Fused push-back wrapper (K3) — port of ``repro/kernels/push_back/ops.py``.

``push_back_fused`` is the ``method="fused"`` backend of
``core.ggarray.push_back``/``append``: per-block insertion offsets and the
scatter into every bucket level in one launch.  The levels are written **in
place** (the reference donates and aliases them) and returned.

A CPU tensor takes the plain version (``ref.push_back``); a CUDA tensor
launches the kernel or raises.  ``memory_space`` and ``dispatch`` select TPU
tilings and insert-permutation backends in the reference; they are checked
and accepted here and change nothing: the GPU kernel scatters directly, and
every value gives the same output.  Nothing here reads the device on the
host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.push_back import kernel as _kernel
from repro_torch.kernels.push_back import ref as _ref

__all__ = ["push_back_fused", "push_back_fused_multi"]


def push_back_fused_multi(
    level_groups: tuple[tuple[torch.Tensor, ...], ...],
    sizes: torch.Tensor,  # (nblocks,) int32
    b0: int,
    elem_groups: tuple[torch.Tensor, ...],  # per group: (nblocks, m, *item_g)
    mask: torch.Tensor,  # (nblocks, m) bool or integer lanes
    *,
    memory_space: str | None = None,
    dispatch: str = "auto",
) -> tuple:
    """→ (level groups written in place, new sizes (nblocks,), positions (−1 masked)).

    On a CUDA device this slice launches one group; more groups raise
    ``NotImplementedError`` (the multi-group launch is queued in ROADMAP.md).
    """
    common.check_memory_space(memory_space)
    common.check_dispatch(dispatch)
    if mask.dtype != torch.bool:
        mask = mask != 0
    nblocks, m = elem_groups[0].shape[:2]
    if m == 0:
        return level_groups, sizes, torch.zeros((nblocks, 0), dtype=torch.int32,
                                                device=sizes.device)
    if sizes.device.type == "cpu":
        new_sizes = pos = None
        for levels, elems in zip(level_groups, elem_groups):
            _, new_sizes, pos = _ref.push_back(levels, sizes, b0, elems, mask)
        return level_groups, new_sizes, pos
    if len(level_groups) != 1:
        raise NotImplementedError(
            "multi-group push-back on CUDA is not ported yet (ROADMAP.md, slice 3)"
        )
    new_sizes, pos = _kernel.push_back_cuda(
        level_groups[0], sizes.to(torch.int32).contiguous(), b0,
        elem_groups[0].contiguous(), mask.contiguous(),
    )
    return level_groups, new_sizes, pos


def push_back_fused(
    levels: tuple[torch.Tensor, ...],
    sizes: torch.Tensor,
    b0: int,
    elems: torch.Tensor,
    mask: torch.Tensor,
    *,
    memory_space: str | None = None,
    dispatch: str = "auto",
) -> tuple:
    """→ (levels written in place, new sizes (nblocks,), positions (−1 masked))."""
    groups, new_sizes, pos = push_back_fused_multi(
        (levels,), sizes, b0, (elems,), mask,
        memory_space=memory_space, dispatch=dispatch,
    )
    return groups[0], new_sizes, pos
