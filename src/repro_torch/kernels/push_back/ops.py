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
host.  ``instrument=True`` (the device counter plane, K15) adds a float32
counter vector to the outputs: the kernel's in-kernel counts on a card, the
plain twin ``ref.counters`` on the CPU.  Lanes are the card's own
(``nblocks·m``, none padded), where the reference counts its TPU tiling
(``obs/device.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.push_back import kernel as _kernel
from repro_torch.kernels.push_back import ref as _ref
from repro_torch.obs import device as obs_device

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
    instrument: bool = False,
    shard: int = 0,
    nshards: "int | tuple[int, ...]" = 1,
) -> tuple:
    """→ (level groups written in place, new sizes (nblocks,), positions (−1 masked)),
    and with ``instrument`` the counter vector.

    Every group shares the mask and the positions.  On a CUDA device all
    groups go through one launch of K3 (up to four groups).  An empty wave
    (m = 0) launches nothing and counts nothing.

    The shard form: the levels are slice ``shard`` of levels split
    ``nshards`` ways along their slots (one count, or one a level; a mesh's
    ``'model'`` axis), and lanes outside the slice write nothing here
    (``ref.push_back``).  The counters describe the whole wave.

    On fake tensors (``FakeTensorMode``: the dry-run) the shape rule stands
    in for the launch: the plain version's scan, uncounted (a fake level
    holds nothing to write), then one noted launch (``common.run_kernel``).
    """
    common.check_memory_space(memory_space)
    common.check_dispatch(dispatch)
    if mask.dtype != torch.bool:
        mask = mask != 0
    nblocks, m = elem_groups[0].shape[:2]
    if m == 0:
        out = (level_groups, sizes,
               torch.zeros((nblocks, 0), dtype=torch.int32, device=sizes.device))
        return out + (obs_device.zeros(sizes.device),) if instrument else out
    nshards = common.level_shards(nshards, len(level_groups[0]))

    def plain():
        new_sizes = pos = None
        for levels, elems in zip(level_groups, elem_groups):
            _, new_sizes, pos = _ref.push_back(levels, sizes, b0, elems, mask, shard=shard,
                                               nshards=nshards)
        if instrument:
            vec = _ref.counters(mask, sizes, b0, len(level_groups[0]))
            return level_groups, new_sizes, pos, vec
        return level_groups, new_sizes, pos

    def rule():
        pos, new_sizes = _ref.scan(sizes, mask)
        out = (level_groups, new_sizes, torch.where(mask, pos, -1))
        return out + (_ref.counters(mask, sizes, b0, len(level_groups[0])),) if instrument else out

    def launch():
        outs = _kernel.push_back_cuda_multi(
            level_groups, sizes.to(torch.int32).contiguous(), b0,
            tuple(e.contiguous() for e in elem_groups), mask.contiguous(), instrument=instrument,
            shard=shard, nshards=nshards,
        )
        if instrument:
            new_sizes, pos, block = outs
            return level_groups, new_sizes, pos, obs_device.from_block(block)
        return (level_groups, *outs)

    if common.on_cpu(sizes):
        return plain()
    levels_all = [lv for levels in level_groups for lv in levels]
    return common.run_kernel(_kernel.launch_name(len(level_groups)),
                             [*levels_all, sizes, *elem_groups, mask], rule, launch)


def push_back_fused(
    levels: tuple[torch.Tensor, ...],
    sizes: torch.Tensor,
    b0: int,
    elems: torch.Tensor,
    mask: torch.Tensor,
    *,
    memory_space: str | None = None,
    dispatch: str = "auto",
    instrument: bool = False,
) -> tuple:
    """→ (levels written in place, new sizes (nblocks,), positions (−1 masked)),
    and with ``instrument`` the counter vector."""
    groups, *rest = push_back_fused_multi(
        (levels,), sizes, b0, (elems,), mask,
        memory_space=memory_space, dispatch=dispatch, instrument=instrument,
    )
    return (groups[0], *rest)
