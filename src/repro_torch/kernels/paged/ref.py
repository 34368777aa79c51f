"""Plain PyTorch versions of the paged kernels — port of ``paged/ref.py``.

Each computes what its kernel computes, on any device: the wrappers in
``ops.py`` take them for CPU tensors, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.  The gathers and the append move data, so
they are bitwise the reference's oracles; the attention (K10/K11) is a float
reduction, held within a stated tolerance.
"""
from __future__ import annotations

import torch

__all__ = ["gather_pages", "gather_pages_extents", "attend_paged", "slab_append", "MASK_VALUE"]

MASK_VALUE = -1e30  # the serving softmax mask of the reference


def gather_pages(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """K8: pool (S, T, D), pages (N, P) int32 → (N, P·T, D); page < 0 → zeros.

    As the reference's flat-pool oracle, ids past the pool read its last slab.
    """
    S, T, D = pool.shape
    N, P = pages.shape
    out = pool[torch.clamp(pages, 0, max(S - 1, 0)).long()]  # (N, P, T, D)
    valid = (pages >= 0)[:, :, None, None]
    return torch.where(valid, out, torch.zeros((), dtype=pool.dtype, device=pool.device)).reshape(
        N, P * T, D
    )


def gather_pages_extents(extents: tuple[torch.Tensor, ...], pages: torch.Tensor) -> torch.Tensor:
    """K9: the same views over extents (each (S_e, T, D)) addressed by global
    slab id; ids < 0 or past the pool → zeros, as the reference resolves them
    through ``pool/extents.resolve_pages``."""
    flat = extents[0] if len(extents) == 1 else torch.cat(extents, 0)
    S, T, D = flat.shape
    N, P = pages.shape
    valid = (pages >= 0) & (pages < S)
    out = flat[torch.clamp(pages, 0, max(S - 1, 0)).long()]
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    return torch.where(valid[:, :, None, None], out, zero).reshape(N, P * T, D)


def attend_paged(
    q: torch.Tensor,  # (B, KH, G, D) f32, pre-scaled
    k_pool: torch.Tensor,  # (KH, S, T, D) — head-major pool layout
    v_pool: torch.Tensor,  # (KH, S, T, D)
    pages: torch.Tensor,  # (B, P) int32
    lengths: torch.Tensor,  # (B,) int32 live tokens per sequence
) -> torch.Tensor:
    """One-token attention through the page table, page at a time: the
    online-softmax merge in page order.  A page past the live length (or an
    unclaimed −1 entry) leaves the state untouched."""
    B, KH, G, D = q.shape
    T = k_pool.shape[2]
    P = pages.shape[1]
    dev = q.device
    m = torch.full((B, KH, G), MASK_VALUE, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KH, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KH, G, D), dtype=torch.float32, device=dev)
    lengths = lengths.to(torch.int32)
    for p in range(P):
        slab = pages[:, p]
        k = k_pool[:, torch.clamp(slab, min=0).long()]  # (KH, B, T, D)
        v = v_pool[:, torch.clamp(slab, min=0).long()]
        s = torch.einsum("bkgd,kbtd->bkgt", q, k.to(torch.float32))
        kpos = p * T + torch.arange(T, dtype=torch.int32, device=dev)
        live = kpos[None, :] < lengths[:, None]  # (B, T)
        s = torch.where(live[:, None, None, :], s, MASK_VALUE)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        pw = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + torch.sum(pw, dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum("bkgt,kbtd->bkgd", pw, v.to(torch.float32))
        use = ((slab >= 0) & (p * T < lengths))[:, None, None]
        m = torch.where(use, m_new, m)
        l = torch.where(use, l_new, l)
        acc = torch.where(use[..., None], acc_new, acc)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def slab_append(
    pool: torch.Tensor,  # (S, T, D)
    owners: torch.Tensor,  # (S,) int32 — owning array per slab, −1 = free
    bases: torch.Tensor,  # (S,) int32 — logical position of the slab's slot 0
    sizes: torch.Tensor,  # (N,) int32 — live elements per array
    elems: torch.Tensor,  # (N, m, D)
    mask: torch.Tensor,  # (N, m) bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K12 → (new pool, new sizes, positions (N, m) (−1 where masked)).

    Per-array exclusive-scan offsets order the wave, and each slab slot
    ``bases[s] + j`` takes wave element ``offset = bases[s] + j − sizes[o]``
    of its owner ``o`` when ``0 ≤ offset < count[o]``.  The reference builds
    the compacted wave with a one-hot reduction (the TPU's insert
    permutation); here a scatter of each live lane to its offset does it in
    O(N·m), with the same result.
    """
    mask_i = mask.to(torch.int32)
    inc = torch.cumsum(mask_i, dim=1, dtype=torch.int32)
    off = inc - mask_i
    counts = inc[:, -1]  # (N,)
    pos = sizes[:, None] + off

    N, m = mask.shape
    D = elems.shape[2]
    # compacted wave: live lane k of row n → column off[n, k]; masked lanes
    # go to a spare column m that is cut off again
    col = torch.where(mask, off, m).long()
    gathered = torch.zeros((N, m + 1, D), dtype=elems.dtype, device=elems.device)
    gathered.scatter_(1, col[:, :, None].expand(N, m, D), elems)
    gathered = gathered[:, :m]

    own = torch.clamp(owners, 0, N - 1).long()
    S, T = pool.shape[:2]
    j = torch.arange(T, dtype=torch.int32, device=pool.device)[None, :]
    o = bases[:, None] + j - sizes[own][:, None]  # wave offset at this slot
    valid = (owners[:, None] >= 0) & (o >= 0) & (o < counts[own][:, None])
    flat_idx = own[:, None] * m + torch.clamp(o, 0, m - 1).long()  # (S, T)
    vals = gathered.reshape(N * m, D)[flat_idx]  # (S, T, D)
    new_pool = torch.where(valid[:, :, None], vals, pool)
    return new_pool, sizes + counts, torch.where(mask, pos, -1)
