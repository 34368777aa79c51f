"""Paged ops: the wrappers around K8/K9, K10/K11 and K12 — port of ``paged/ops.py``.

A pool argument is one tensor ``(S, T, *item)``, a tuple or list of extents
``(S_e, T, *item)`` in global slab-id order, or a
:class:`repro_torch.pool.extents.ExtentPool`.  Empty extents hold no slab
ids and are dropped.  A CPU tensor takes the plain versions in ``ref.py``;
a CUDA tensor launches the kernel or raises.  ``memory_space`` and
``dispatch`` select a TPU tiling and insert-permutation backend in the
reference; they are checked and have no effect here.  ``instrument=True``
(the reference's device counter plane, K15) raises ``NotImplementedError``
until the counter plane is ported.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import common
from repro_torch.kernels.paged import kernel as _kernel
from repro_torch.kernels.paged import ref as _ref

__all__ = ["paged_gather", "paged_attend", "slab_append"]


def _no_instrument(instrument: bool) -> None:
    if instrument:
        raise NotImplementedError(
            "instrument=True needs the device counter plane (K15), not ported "
            "yet (ROADMAP.md, Queue 2)"
        )


def _extents_of(pool: Any) -> tuple[tuple[torch.Tensor, ...], bool]:
    """→ (extents, is_multi): a tensor is one extent; a tuple/list or an
    ``ExtentPool`` is a segmented pool."""
    if isinstance(pool, torch.Tensor):
        return (pool,), False
    exts = getattr(pool, "extents", pool)
    return tuple(exts), True


def _live(exts: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    """Drop empty extents (they hold no slab ids, so the numbering stays)."""
    return tuple(e for e in exts if e.shape[0] > 0) or exts[:1]


def _flat_item(x: torch.Tensor, lead: int) -> torch.Tensor:
    """Collapse everything past ``lead`` leading dims into one feature axis."""
    d = 1
    for dim in x.shape[lead:]:
        d *= dim
    return x.reshape(*x.shape[:lead], d)


def paged_gather(
    pool: Any,
    pages: torch.Tensor,  # (N, P) int32 — global slab ids
    *,
    memory_space: str | None = None,
    instrument: bool = False,
) -> torch.Tensor:
    """→ (N, P·T, *item) contiguous logical views (zeros under page −1).

    One extent is K8, several are K9.  Ids past the pool read zeros through
    extents and the last slab of a flat pool, as in the reference.
    """
    common.check_memory_space(memory_space)
    _no_instrument(instrument)
    exts = _live(_extents_of(pool)[0])
    T, item = exts[0].shape[1], tuple(exts[0].shape[2:])
    N, P = pages.shape
    if sum(e.shape[0] for e in exts) == 0:
        return torch.zeros((N, P * T, *item), dtype=exts[0].dtype, device=exts[0].device)
    if exts[0].device.type == "cpu":
        flat = tuple(_flat_item(e, 2) for e in exts)
        if len(flat) == 1:
            out = _ref.gather_pages(flat[0], pages)
        else:
            out = _ref.gather_pages_extents(flat, pages)
        return out.reshape(N, P * T, *item)
    return _kernel.paged_gather_cuda(exts, pages.to(torch.int32).contiguous(),
                                     clip_high=len(exts) == 1)


def paged_attend(
    q: torch.Tensor,  # (B, KH, G, D) f32, pre-scaled
    k_pool: Any,  # (S, T, KH, D) token-major pool, or extents
    v_pool: Any,
    pages: torch.Tensor,  # (B, P) int32 — global slab ids
    lengths: torch.Tensor,  # (B,) int32
    *,
    memory_space: str | None = None,
    instrument: bool = False,
) -> torch.Tensor:
    """→ (B, KH, G, D) f32 attention output through the page table.

    One extent is K10, several are K11; both read the token-major slabs in
    place (no transpose, no concatenation of extents on the card).  The
    plain version on the CPU takes the reference's head-major view of the
    concatenated pool.  A pool with no slabs attends to nothing: zeros.
    """
    common.check_memory_space(memory_space)
    _no_instrument(instrument)
    k_exts = _live(_extents_of(k_pool)[0])
    v_exts = _live(_extents_of(v_pool)[0])
    if sum(e.shape[0] for e in k_exts) == 0:
        return torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    if q.device.type != "cpu":
        return _kernel.paged_attend_cuda(
            q.to(torch.float32).contiguous(), k_exts, v_exts,
            pages.to(torch.int32).contiguous(), lengths.to(torch.int32).contiguous(),
        )
    k1 = k_exts[0] if len(k_exts) == 1 else torch.cat(k_exts, 0)
    v1 = v_exts[0] if len(v_exts) == 1 else torch.cat(v_exts, 0)
    return _ref.attend_paged(q, k1.permute(2, 0, 1, 3), v1.permute(2, 0, 1, 3), pages, lengths)


def slab_append(
    pool: Any,
    owners: torch.Tensor,  # (S,) int32 — owning array per slab, −1 free
    bases: torch.Tensor,  # (S,) int32 — logical position of each slab's slot 0
    sizes: torch.Tensor,  # (N,) int32
    elems: torch.Tensor,  # (N, m, *item)
    mask: torch.Tensor,  # (N, m) bool or 0/1 int
    *,
    memory_space: str | None = None,
    dispatch: str = "auto",
    instrument: bool = False,
) -> tuple:
    """→ (pool, new sizes (N,), positions (N, m) (−1 where masked)).

    The pool is written **in place** (the reference donates it) and comes
    back with the structure it came in: a tensor, or a tuple of extents.
    On a CUDA device all extents take one launch of K12.
    """
    common.check_memory_space(memory_space)
    common.check_dispatch(dispatch)
    _no_instrument(instrument)
    if mask.dtype != torch.bool:
        mask = mask != 0
    exts, is_multi = _extents_of(pool)
    ret = tuple(exts) if is_multi else exts[0]
    N, m = mask.shape
    sizes = sizes.to(torch.int32)
    if m == 0:
        return ret, sizes, torch.zeros((N, 0), dtype=torch.int32, device=sizes.device)
    if exts[0].device.type != "cpu":
        new_sizes, pos = _kernel.slab_append_cuda(
            exts, owners.to(torch.int32).contiguous(), bases.to(torch.int32).contiguous(),
            sizes.contiguous(), elems.contiguous(), mask.contiguous(),
        )
        return ret, new_sizes, pos
    flat = [_flat_item(e, 2) for e in exts]
    pool3 = flat[0] if len(flat) == 1 else torch.cat(flat, 0)
    new_pool, new_sizes, pos = _ref.slab_append(
        pool3, owners.to(torch.int32), bases.to(torch.int32), sizes, _flat_item(elems, 2), mask
    )
    lo = 0
    for e, f in zip(exts, flat):
        f.copy_(new_pool[lo:lo + e.shape[0]])  # f is a view of e: in place
        lo += e.shape[0]
    return ret, new_sizes, pos

