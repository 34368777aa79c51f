"""Plain PyTorch versions of the paged kernels — port of ``paged/ref.py``.

Each computes what its kernel computes, on any device: the wrappers in
``ops.py`` take them for CPU tensors, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.  The gathers and the append move data, so
they are bitwise the reference's oracles; the attention (K10/K11) is a float
reduction, held within a stated tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.obs import device as obs_device

__all__ = ["gather_pages", "gather_pages_extents", "attend_paged", "slab_append",
           "gather_counters", "attend_counters", "append_counters", "MASK_VALUE"]

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


# --------------------------------------------------------------------------
# device counters (K15): the plain twins of the in-kernel counts, float32
# vectors in obs/device.py's layout.
# --------------------------------------------------------------------------

def _live_pages(pages: torch.Tensor, n_slabs: int, clip_high: bool) -> torch.Tensor:
    """Page entries that resolve to a slab: ids ≥ 0, and below the slab
    count unless ids past one flat pool clip to its last slab."""
    live = pages >= 0
    return live if clip_high else live & (pages < n_slabs)


def gather_counters(pages: torch.Tensor, n_slabs: int, clip_high: bool) -> torch.Tensor:
    """K8/K9's counters: one launch, live page tiles, and ``masked_tiles`` =
    N·P − live — the reference's count (``paged/ops.py:30``) without its
    vmem tiling's padded rows."""
    live = _live_pages(pages, n_slabs, clip_high).to(torch.int64).sum()
    return obs_device.pack(pages.device, **{
        "paged_gather.launches": 1,
        "paged_gather.tiles": live,
        "paged_gather.masked_tiles": pages.numel() - live,
    })


def attend_counters(pages: torch.Tensor, lengths: torch.Tensor, T: int, KH: int,
                    n_slabs: int, clip_high: bool) -> torch.Tensor:
    """K10/K11's counters over the reference's (B, KH, P) walk
    (``paged/ops.py:44``): a page is visited when its id resolves and its
    first token lies inside the length; visited tiles carry T score lanes,
    of which those at or past the length are masked."""
    B, P = pages.shape
    p_idx = torch.arange(P, dtype=torch.int64, device=pages.device)[None, :]
    kv = lengths.to(torch.int64)[:, None]
    visit = (_live_pages(pages, n_slabs, clip_high) & (p_idx * T < kv)).to(torch.int64)
    masked = visit * (T - torch.clamp(kv - p_idx * T, 0, T))
    tiles = visit.sum()
    return obs_device.pack(pages.device, **{
        "paged_attend.launches": 1,
        "paged_attend.tiles": KH * tiles,
        "paged_attend.tiles_skipped": KH * (B * P - tiles),
        "paged_attend.lanes": KH * T * tiles,
        "paged_attend.masked_lanes": KH * masked.sum(),
    })


def append_counters(mask: torch.Tensor) -> torch.Tensor:
    """K12's wave accounting (the reference counts it at the ops level too,
    ``paged/ops.py:225``): one wave of N·m lanes, unpadded."""
    N, m = mask.shape
    return obs_device.pack(mask.device, **{
        "slab_append.waves": 1,
        "slab_append.lanes": N * m,
        "slab_append.active_lanes": mask.to(torch.int64).sum(),
    })
