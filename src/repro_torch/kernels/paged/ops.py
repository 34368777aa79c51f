"""Paged ops: the wrappers around K8/K9, K10/K11 and K12 — port of ``paged/ops.py``.

A pool argument is one tensor ``(S, T, *item)``, a tuple or list of extents
``(S_e, T, *item)`` in global slab-id order, or a
:class:`repro_torch.pool.extents.ExtentPool`.  Empty extents hold no slab
ids and are dropped.  A CPU tensor takes the plain versions in ``ref.py``;
a CUDA tensor launches the kernel or raises.  ``memory_space`` and
``dispatch`` select a TPU tiling and insert-permutation backend in the
reference; they are checked and have no effect here.  ``instrument=True``
(the device counter plane, K15) adds a float32 counter vector to the
outputs: K8/K9 and K10/K11 count in-kernel on a card, the plain twins in
``ref.py`` count on the CPU, and the slab append (K12) is counted here, at
the ops level, as the reference counts it.  ``paged_gather.masked_tiles``
and ``slab_append.lanes`` count the card's own tiles and lanes, where the
reference counts its TPU tiling (``obs/device.py``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import common
from repro_torch.kernels.paged import kernel as _kernel
from repro_torch.kernels.paged import ref as _ref
from repro_torch.obs import device as obs_device

__all__ = ["paged_gather", "paged_attend", "slab_append"]


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
):
    """→ (N, P·T, *item) contiguous logical views (zeros under page −1), and
    with ``instrument`` the counter vector.

    One extent is K8, several are K9.  Ids past the pool read zeros through
    extents and the last slab of a flat pool, as in the reference.
    """
    common.check_memory_space(memory_space)
    exts = _live(_extents_of(pool)[0])
    T, item = exts[0].shape[1], tuple(exts[0].shape[2:])
    N, P = pages.shape
    n_slabs = sum(e.shape[0] for e in exts)
    if n_slabs == 0:
        out = torch.zeros((N, P * T, *item), dtype=exts[0].dtype, device=exts[0].device)
        return (out, _ref.gather_counters(pages, 0, False)) if instrument else out
    if exts[0].device.type == "cpu":
        flat = tuple(_flat_item(e, 2) for e in exts)
        if len(flat) == 1:
            out = _ref.gather_pages(flat[0], pages)
        else:
            out = _ref.gather_pages_extents(flat, pages)
        out = out.reshape(N, P * T, *item)
        if instrument:
            return out, _ref.gather_counters(pages, n_slabs, clip_high=len(flat) == 1)
        return out
    outs = _kernel.paged_gather_cuda(exts, pages.to(torch.int32).contiguous(),
                                     clip_high=len(exts) == 1, instrument=instrument)
    if instrument:
        return outs[0], obs_device.from_block(outs[1])
    return outs


def paged_attend(
    q: torch.Tensor,  # (B, KH, G, D) f32, pre-scaled
    k_pool: Any,  # (S, T, KH, D) token-major pool, or extents
    v_pool: Any,
    pages: torch.Tensor,  # (B, P) int32 — global slab ids
    lengths: torch.Tensor,  # (B,) int32
    *,
    memory_space: str | None = None,
    instrument: bool = False,
):
    """→ (B, KH, G, D) f32 attention output through the page table, and with
    ``instrument`` the counter vector.

    One extent is K10, several are K11; both read the token-major slabs in
    place (no transpose, no concatenation of extents on the card).  The
    plain version on the CPU takes the reference's head-major view of the
    concatenated pool.  A pool with no slabs attends to nothing: zeros.
    """
    common.check_memory_space(memory_space)
    k_exts = _live(_extents_of(k_pool)[0])
    v_exts = _live(_extents_of(v_pool)[0])
    n_slabs = sum(e.shape[0] for e in k_exts)
    T, KH = k_exts[0].shape[1], k_exts[0].shape[2]

    def plain_counters():
        return _ref.attend_counters(pages, lengths, T, KH, n_slabs, clip_high=len(k_exts) == 1)

    if n_slabs == 0:
        out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        return (out, plain_counters()) if instrument else out
    if q.device.type != "cpu":
        outs = _kernel.paged_attend_cuda(
            q.to(torch.float32).contiguous(), k_exts, v_exts,
            pages.to(torch.int32).contiguous(), lengths.to(torch.int32).contiguous(),
            instrument=instrument,
        )
        if instrument:
            return outs[0], obs_device.from_block(outs[1])
        return outs
    k1 = k_exts[0] if len(k_exts) == 1 else torch.cat(k_exts, 0)
    v1 = v_exts[0] if len(v_exts) == 1 else torch.cat(v_exts, 0)
    out = _ref.attend_paged(q, k1.permute(2, 0, 1, 3), v1.permute(2, 0, 1, 3), pages, lengths)
    return (out, plain_counters()) if instrument else out


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
    """→ (pool, new sizes (N,), positions (N, m) (−1 where masked)), and with
    ``instrument`` the wave-accounting vector (``ref.append_counters``).

    The pool is written **in place** (the reference donates it) and comes
    back with the structure it came in: a tensor, or a tuple of extents.
    On a CUDA device all extents take one launch of K12.
    """
    common.check_memory_space(memory_space)
    common.check_dispatch(dispatch)
    if mask.dtype != torch.bool:
        mask = mask != 0
    exts, is_multi = _extents_of(pool)
    ret = tuple(exts) if is_multi else exts[0]
    N, m = mask.shape
    sizes = sizes.to(torch.int32)
    if m == 0:
        out = (ret, sizes, torch.zeros((N, 0), dtype=torch.int32, device=sizes.device))
        return out + (obs_device.zeros(sizes.device),) if instrument else out
    vec = (_ref.append_counters(mask),) if instrument else ()
    if exts[0].device.type != "cpu":
        new_sizes, pos = _kernel.slab_append_cuda(
            exts, owners.to(torch.int32).contiguous(), bases.to(torch.int32).contiguous(),
            sizes.contiguous(), elems.contiguous(), mask.contiguous(),
        )
        return (ret, new_sizes, pos, *vec)
    flat = [_flat_item(e, 2) for e in exts]
    pool3 = flat[0] if len(flat) == 1 else torch.cat(flat, 0)
    new_pool, new_sizes, pos = _ref.slab_append(
        pool3, owners.to(torch.int32), bases.to(torch.int32), sizes, _flat_item(elems, 2), mask
    )
    lo = 0
    for e, f in zip(exts, flat):
        f.copy_(new_pool[lo:lo + e.shape[0]])  # f is a view of e: in place
        lo += e.shape[0]
    return (ret, new_sizes, pos, *vec)

