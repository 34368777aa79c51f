"""KV-cache policies — port of ``repro/serving/kvcache.py``.

``static``   pre-allocate the worst-case length (the paper's static array);
             appends past the capacity are dropped.
``semistatic`` a doubling buffer; the engine copies the whole cache on
             growth (the host-resize baseline).
``ggarray``  geometric seq-dim buckets (bucket b holds ``B0·2^b`` steps):
             growth appends a bucket, never copies.  Decode appends through
             the fused push-back (K3), k and v as two payload groups of one
             launch; attention walks the bucket chain with online-softmax
             merging.
``paged``    the slab arena: K/V live in one shared pool of
             ``slab_tokens``-sized slabs (one tensor, or a tuple of extents);
             each sequence holds a page table of slab ids.  Attention walks
             the pages in geometric groups (``paged_attend_impl="levels"``)
             or runs K10/K11 (``"pallas"``).

``two_phase`` (served by ``serving/engine.py``) grows a ggarray cache in
prefill and freezes it (:func:`freeze_cache`) into the static layout for
decode; on capacity it thaws (:func:`thaw_cache`), grows a level and
refreezes.  A static or frozen cache is one ``(…, B, cap, KH, Dh)`` tensor
per K and V; attention over it is one softmax pass in plain PyTorch, as the
reference's (the contiguous-cache kernel K14 is ``kernels/decode_attention``,
held against this layout but not called from here).

A cache *slot* (one attention layer kind) is a dict of tensors, exactly the
reference's keys and shapes.  Where the reference returns a new dict, the
port writes the tensors **in place** and returns the same dict (growth
returns a new dict that shares the old levels, so nothing is copied).  Every
function here is free of host syncs: indices and masks stay on the device,
host values are Python ints.  The int8 caches (``cache_quant``) raise
``NotImplementedError`` (ROADMAP.md, Queue 1).

With ``cfg.instrument`` the ops record device counter vectors (K15,
``obs/device.py``) on the serving step's tape at the reference's sites:
the paged decode append and the chunk append (slab-append wave
accounting), the ggarray append (K3's counters), the paged walk (K10/K11's
counters, or ``_levels_walk_ctr`` for the group walk) and the prefix
gather of chunked prefill.  The numbers describe the reference's walks,
whatever shortcut the port takes, so the two packages' totals agree.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import indexing
from repro_torch.device import resolve
from repro_torch.kernels import common
from repro_torch.models.attention import MASK_VALUE, SoftmaxState, softmax_update
from repro_torch.obs import device as obs_device
from repro_torch.pool.arena import geometric_page_groups

__all__ = [
    "init_cache",
    "cache_capacity",
    "capacity_of",
    "append",
    "attend",
    "copy_slab",
    "chunk_attend",
    "scatter_chunk",
    "grow_ggarray",
    "freeze_cache",
    "thaw_cache",
    "fill_from_prefill",
    "needed_levels",
    "cache_bytes",
    "period_view",
    "POLICIES",
]

Cache = dict[str, Any]
POLICIES = ("static", "semistatic", "ggarray", "paged", "two_phase")
_F32 = torch.float32


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, Queue 1)")


def _check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown cache policy {policy!r}; options: {POLICIES}")


def needed_levels(b0: int, length: int) -> int:
    return max(indexing.min_buckets_for(b0, length), 1)


def cache_capacity(cfg: ModelConfig, policy: str, length_hint: int) -> int:
    _check_policy(policy)
    if policy == "static":
        return length_hint
    if policy == "semistatic":
        cap = max(cfg.cache_b0, 1)
        while cap < length_hint:
            cap *= 2
        return cap
    if policy == "paged":
        T = cfg.slab_tokens
        return max(-(-length_hint // T), 1) * T
    return indexing.capacity(cfg.cache_b0, needed_levels(cfg.cache_b0, length_hint))


def init_cache(
    cfg: ModelConfig,
    batch: int,
    length_hint: int,
    policy: str | None = None,
    *,
    stack: int | None = None,
    dtype: torch.dtype | None = None,
    device: "torch.device | str | None" = None,
) -> Cache:
    """Empty cache slot sized for ``length_hint`` under ``policy``.

    ``stack``: leading periods dim (the layer stack).  ``dtype`` defaults to
    ``cfg.dtype``.  ``device=None`` means the card (``device.resolve``).
    """
    from repro_torch.models.transformer import DTYPES

    device = resolve(device)
    policy = cfg.cache_policy if policy is None else policy
    _check_policy(policy)
    if cfg.cache_quant:
        raise _not_ported("the int8 KV cache (cache_quant)")
    dtype = DTYPES[cfg.dtype] if dtype is None else dtype
    lead = (stack,) if stack else ()
    kh, dh = cfg.n_kv_heads, cfg.head_dim

    def z(*shape):
        return torch.zeros((*lead, *shape), dtype=dtype, device=device)

    if policy in ("static", "semistatic"):
        cap = cache_capacity(cfg, policy, length_hint)
        return {"k": z(batch, cap, kh, dh), "v": z(batch, cap, kh, dh)}
    if policy == "paged":
        # standalone slot: sequence b owns slabs [b·maxp, (b+1)·maxp)
        T = cfg.slab_tokens
        maxp = max(-(-length_hint // T), 1)
        n_slabs = batch * maxp
        base = torch.arange(n_slabs, dtype=torch.int32, device=device).reshape(batch, maxp)
        return {
            "k_pool": z(n_slabs, T, kh, dh),
            "v_pool": z(n_slabs, T, kh, dh),
            "pages": base.expand(*lead, batch, maxp).clone(),
        }
    cache: Cache = {}
    for lvl, size in enumerate(indexing.bucket_sizes(cfg.cache_b0, needed_levels(cfg.cache_b0, length_hint))):
        cache[f"k{lvl}"] = z(batch, size, kh, dh)
        cache[f"v{lvl}"] = z(batch, size, kh, dh)
    return cache


def period_view(cache: Cache, i: int) -> Cache:
    """Period ``i`` of a stacked cache slot: views, so writes land in place."""
    return {k: tuple(e[i] for e in v) if isinstance(v, tuple) else v[i] for k, v in cache.items()}


def _levels(cache: Cache) -> int:
    n = 0
    while f"k{n}" in cache:
        n += 1
    return n


def _is_ggarray(cache: Cache) -> bool:
    return "k0" in cache


def _is_paged(cache: Cache) -> bool:
    return "k_pool" in cache


# ---- pools: one tensor (flat) or a tuple of extents -----------------------

def _pool_exts(pool) -> tuple[torch.Tensor, ...]:
    return tuple(pool) if isinstance(pool, (tuple, list)) else (pool,)


def _pool_first(pool) -> torch.Tensor:
    return _pool_exts(pool)[0]


def _extent_starts(exts, axis: int = 0) -> list[int]:
    starts, s = [], 0
    for e in exts:
        starts.append(s)
        s += e.shape[axis]
    return starts


def _scatter_pool(pool, slab: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor) -> None:
    """``pool[slab, slot] = vals`` in place through the extents; lanes whose
    ``slab`` is < 0 or past the pool write nothing (the reference's drop)."""
    exts = _pool_exts(pool)
    for ext, s0 in zip(exts, _extent_starts(exts)):
        local = slab - s0
        common.put_drop_(ext, (local, slot), (slab >= 0) & (local >= 0) & (local < ext.shape[0]), vals)


def _scatter_slab(pool, slab: torch.Tensor, vals: torch.Tensor) -> None:
    """Whole-slab ``pool[slab] = vals`` in place; out-of-pool lanes drop."""
    exts = _pool_exts(pool)
    for ext, s0 in zip(exts, _extent_starts(exts)):
        local = slab - s0
        common.put_drop_(ext, (local,), (slab >= 0) & (local >= 0) & (local < ext.shape[0]), vals)


def _gather_pool(pool, grp: torch.Tensor) -> torch.Tensor:
    """pool (S, T, …) or extents, page group (B, w) → (B, w·T, …).

    On one flat pool −1 pages gather slab 0 (their lanes are masked); through
    extents an id outside every extent gathers zeros — both as the reference.
    """
    exts = _pool_exts(pool)
    T = exts[0].shape[1]
    B, w = grp.shape
    item = exts[0].shape[2:]
    if len(exts) == 1:
        S = exts[0].shape[0]
        out = exts[0][torch.clamp(grp, 0, max(S - 1, 0)).long()]
        return out.reshape(B, w * T, *item)
    out = torch.zeros((B, w, T, *item), dtype=exts[0].dtype, device=exts[0].device)
    for ext, s0 in zip(exts, _extent_starts(exts)):
        local = grp - s0
        g = ext[torch.clamp(local, 0, ext.shape[0] - 1).long()]
        sel = ((local >= 0) & (local < ext.shape[0])).reshape(B, w, *([1] * (g.ndim - 2)))
        out = torch.where(sel, g, out)
    return out.reshape(B, w * T, *item)


def copy_slab(pool, src: int, dst: int, *, axis: int = 0):
    """Device copy of one slab ``src → dst`` across the flat or extent
    layout, in place (the copy-on-write private copy of the reference; only
    one slab's bytes move).  ``src``/``dst`` are host ints; ``axis`` is the
    slab axis (0 for a slot's pools, 1 for the engine's period-stacked
    pools).  Returns ``pool``."""
    exts = _pool_exts(pool)

    def locate(s: int) -> tuple[int, int]:
        for e, (ext, s0) in enumerate(zip(exts, _extent_starts(exts, axis))):
            if s < s0 + ext.shape[axis]:
                return e, s - s0
        raise IndexError(f"slab {s} outside pool of {sum(e.shape[axis] for e in exts)}")

    (se, so), (de, do) = locate(src), locate(dst)
    lead = (slice(None),) * axis
    exts[de][lead + (do,)] = exts[se][lead + (so,)]
    return pool


def capacity_of(cache: Cache) -> int:
    """Sequence-slot capacity of one cache slot — shapes only, no device read."""
    if _is_paged(cache):
        return cache["pages"].shape[-1] * _pool_first(cache["k_pool"]).shape[-3]
    if "k" in cache:
        return cache["k"].shape[-3]
    return indexing.capacity(cache["k0"].shape[-3], _levels(cache))


def grow_ggarray(cache: Cache, cfg: ModelConfig, levels: int = 1) -> Cache:
    """Copy-free growth: a new dict with the next geometric level(s) appended
    as zeros; the existing levels are the same tensors."""
    n = _levels(cache)
    proto = cache["k0"]
    out = dict(cache)
    for lvl in range(n, n + levels):
        shape = (*proto.shape[:-3], cfg.cache_b0 * (1 << lvl), *proto.shape[-2:])
        out[f"k{lvl}"] = torch.zeros(shape, dtype=proto.dtype, device=proto.device)
        out[f"v{lvl}"] = torch.zeros(shape, dtype=proto.dtype, device=proto.device)
    return out


def cache_bytes(cache: Cache) -> int:
    total = 0
    for v in cache.values():
        for t in _pool_exts(v):
            total += t.numel() * t.element_size()
    return total


# --------------------------------------------------------------------------
# freeze / thaw — the two-phase handoff at the prefill → decode boundary.
#
# Level ``lvl`` of a ggarray cache covers the contiguous positions
# [start_lvl, start_lvl + size_lvl), so freezing is a concatenation along
# the sequence axis and thawing the inverse slicing.  Both make new tensors
# (the once-per-phase O(n) copy the pattern amortises); the source is left
# untouched.
# --------------------------------------------------------------------------

_SEQ_AXIS = -3


def freeze_cache(cache: Cache) -> Cache:
    """ggarray cache → contiguous static-layout cache; other keys (and an
    already static cache) pass through."""
    if not _is_ggarray(cache):
        return dict(cache)
    n = _levels(cache)
    out = {key: val for key, val in cache.items()
           if not (key[:1] in ("k", "v") and key[1:].isdigit())}
    for base in ("k", "v"):
        out[base] = torch.cat([cache[f"{base}{lvl}"] for lvl in range(n)], dim=_SEQ_AXIS)
    return out


def _slice_level(arr: torch.Tensor, lo: int, size: int, axis: int) -> torch.Tensor:
    """A new contiguous ``arr[..., lo:lo+size, ...]`` along ``axis``,
    zero-padded to ``size``."""
    axis = axis % arr.ndim
    take = max(min(arr.shape[axis] - lo, size), 0)
    shape = list(arr.shape)
    shape[axis] = size
    out = torch.zeros(shape, dtype=arr.dtype, device=arr.device)
    if take:
        out.narrow(axis, 0, take).copy_(arr.narrow(axis, lo, take))
    return out


def thaw_cache(cache: Cache, b0: int) -> Cache:
    """Contiguous static-layout cache → ggarray cache: the smallest bucket
    chain covering the frozen buffer, its last level zero-padded past it."""
    if _is_ggarray(cache):
        return dict(cache)
    cap = cache["k"].shape[_SEQ_AXIS]
    nlev = max(indexing.min_buckets_for(b0, cap), 1)
    starts = indexing.bucket_starts(b0, nlev)
    sizes = indexing.bucket_sizes(b0, nlev)
    out = {key: val for key, val in cache.items() if key not in ("k", "v")}
    for base in ("k", "v"):
        for lvl in range(nlev):
            out[f"{base}{lvl}"] = _slice_level(cache[base], int(starts[lvl]), int(sizes[lvl]),
                                               _SEQ_AXIS)
    return out


# --------------------------------------------------------------------------
# append — push_back of one decode step. k/v: (B, 1, KH, Dh); pos: (B,) or ().
# --------------------------------------------------------------------------

def append(cache: Cache, k: torch.Tensor, v: torch.Tensor, pos, cfg: ModelConfig | None = None) -> Cache:
    """Write one decode step at ``pos`` in place → ``cache``.

    ggarray: one fused push-back (K3 on a card) with two payload groups, k
    and v, sharing the mask.  The reference picks its plain scan path for
    one-lane waves from a TPU crossover (``kvcache.py:456``); that choice has
    no counterpart here.  ``cfg.kernel_memory_space`` is checked and inert.
    """
    B = k.shape[0]
    dev = k.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B)
    if _is_paged(cache):
        T = _pool_first(cache["k_pool"]).shape[-3]
        maxp = cache["pages"].shape[-1]
        rows = torch.arange(B, device=dev)
        pidx = torch.clamp(pos // T, 0, maxp - 1)
        slab = cache["pages"][rows, pidx.long()]
        slab = torch.where((slab >= 0) & (pos < maxp * T), slab, -1)  # ⇒ drop
        slot = pos % T
        if cfg is not None and cfg.instrument:
            # one decode token per lane; a −1 slab is a dropped (wasted) lane
            obs_device.record(obs_device.pack(dev, **{
                "slab_append.waves": 1,
                "slab_append.lanes": B,
                "slab_append.active_lanes": (slab >= 0).sum(),
            }))
        _scatter_pool(cache["k_pool"], slab, slot, k[:, 0])
        _scatter_pool(cache["v_pool"], slab, slot, v[:, 0])
        return cache
    if not _is_ggarray(cache):  # static: writes at or past the capacity drop
        cap = cache["k"].shape[-3]
        rows = torch.arange(B, device=dev)
        ok = (pos >= 0) & (pos < cap)
        common.put_drop_(cache["k"], (rows, pos), ok, k[:, 0])
        common.put_drop_(cache["v"], (rows, pos), ok, v[:, 0])
        return cache
    from repro_torch.kernels.push_back import ops as push_back_ops

    n = _levels(cache)
    groups = tuple(tuple(cache[f"{base}{lvl}"] for lvl in range(n)) for base in ("k", "v"))
    inst = cfg is not None and cfg.instrument
    outs = push_back_ops.push_back_fused_multi(
        groups, pos, cache["k0"].shape[-3], (k, v),
        torch.ones((B, 1), dtype=torch.bool, device=dev),
        memory_space=cfg.kernel_memory_space if cfg is not None else None,
        instrument=inst,
    )
    if inst:
        obs_device.record(outs[3])
    return cache


# --------------------------------------------------------------------------
# attend — one-token attention against the cache (rw_b bucket walk).
# --------------------------------------------------------------------------

def _partial_scores(q, k, v, kpos, live_len, state):
    """Online-softmax update of ``state`` with one K/V segment.

    q: (B, KH, G, Dh) f32 · k/v: (B, L, KH, Dh) · kpos: (L,) global positions.
    """
    m, l, acc = state
    s = torch.einsum("bkgd,blkd->bkgl", q, k.to(_F32))
    live = kpos[None, :] < live_len[:, None]  # (B, L)
    s = torch.where(live[:, None, None, :], s, MASK_VALUE)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + torch.sum(p, dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bkgl,blkd->bkgd", p, v.to(_F32))
    return m_new, l, acc


def attend(cache: Cache, q: torch.Tensor, length, cfg: ModelConfig) -> torch.Tensor:
    """q: (B, 1, H, Dh); ``length``: live entries per sequence ((B,) or ()).
    → (B, 1, H, Dh) in ``q.dtype``.  ggarray: one partial-softmax pass per
    bucket level, merged online.  static/frozen: one pass.  paged: the geometric page-group walk, or
    K10/K11 under ``paged_attend_impl="pallas"``."""
    B, _, H, Dh = q.shape
    kh = cfg.n_kv_heads
    g = H // kh
    dev = q.device
    qf = q[:, 0].reshape(B, kh, g, Dh).to(_F32) * (Dh ** -0.5)
    length = torch.as_tensor(length, dtype=torch.int32, device=dev).expand(B)
    state = (
        torch.full((B, kh, g), MASK_VALUE, dtype=_F32, device=dev),
        torch.zeros((B, kh, g), dtype=_F32, device=dev),
        torch.zeros((B, kh, g, Dh), dtype=_F32, device=dev),
    )
    if _is_paged(cache):
        out = _attend_paged(cache, qf, length, cfg, state)
        return out.reshape(B, 1, H, Dh).to(q.dtype)
    if _is_ggarray(cache):
        n = _levels(cache)
        starts = indexing.bucket_starts(cache["k0"].shape[-3], n)
        for lvl in range(n):
            kk = cache[f"k{lvl}"]
            kpos = int(starts[lvl]) + torch.arange(kk.shape[-3], device=dev)
            state = _partial_scores(qf, kk, cache[f"v{lvl}"], kpos, length, state)
    else:  # static or frozen: one segment, one softmax pass
        kpos = torch.arange(cache["k"].shape[-3], device=dev)
        state = _partial_scores(qf, cache["k"], cache["v"], kpos, length, state)
    m, l, acc = state
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def _levels_walk_ctr(pages: torch.Tensor, length: torch.Tensor, T: int) -> torch.Tensor:
    """Device counters of the geometric page-group walk — port of the
    reference's ``_levels_walk_ctr`` (``serving/kvcache.py:579``): every
    group is gathered at its padded power-of-two width (−1 pages included:
    the walk masks them, it does not skip them), so ``masked_lanes`` is the
    over-read this path pays against the gated K10/K11.  Two pools are
    gathered, k and v (the int8 caches' scale pools are not ported)."""
    npools = 2
    B = pages.shape[0]
    tiles = lanes = 0
    live_pages = masked = torch.zeros((), dtype=torch.int64, device=pages.device)
    kv = length.to(torch.int64)
    for lo, hi in geometric_page_groups(pages.shape[-1]):
        full = 1 << max(hi - lo - 1, 0).bit_length()
        tiles += B * full
        lanes += B * full * T
        live_pages = live_pages + (pages[:, lo:hi] >= 0).sum()
        masked = masked + (full * T - torch.clamp(kv - lo * T, 0, full * T)).sum()
    return obs_device.pack(pages.device, **{
        "paged_gather.launches": npools,
        "paged_gather.tiles": npools * live_pages,
        "paged_gather.masked_tiles": npools * (tiles - live_pages),
        "paged_attend.launches": 1,
        "paged_attend.tiles": tiles,
        "paged_attend.lanes": lanes,
        "paged_attend.masked_lanes": masked,
    })


def _attend_paged(cache, qf, length, cfg, state):
    """The paged walk: geometric page groups, or the flash-decode kernel."""
    pages = cache["pages"]
    T = _pool_first(cache["k_pool"]).shape[-3]
    if cfg.paged_attend_impl == "pallas":
        from repro_torch.kernels.paged import ops as paged_ops

        out = paged_ops.paged_attend(
            qf, cache["k_pool"], cache["v_pool"], pages, length,
            memory_space=cfg.kernel_memory_space, instrument=cfg.instrument,
        )
        if cfg.instrument:
            out, vec = out
            obs_device.record(vec)
        return out
    if cfg.instrument:
        obs_device.record(_levels_walk_ctr(pages, length, T))
    for lo, hi in geometric_page_groups(pages.shape[-1]):
        width = hi - lo
        full = 1 << max(width - 1, 0).bit_length()
        grp = pages[:, lo:hi]
        if width < full:  # pad to the ggarray level width (exact no-op lanes)
            grp = torch.cat([grp, grp.new_full((grp.shape[0], full - width), -1)], dim=1)
        kpos = lo * T + torch.arange(full * T, device=qf.device)
        state = _partial_scores(qf, _gather_pool(cache["k_pool"], grp),
                                _gather_pool(cache["v_pool"], grp), kpos, length, state)
    m, l, acc = state
    return acc / torch.clamp(l[..., None], min=1e-30)


# --------------------------------------------------------------------------
# chunked prefill over a paged slot — prefix walk + in-chunk causal pass.
#
# The update is ``attention.softmax_update``, the blockwise attention's own
# step: same einsums, same mask/max/exp/accumulate order, so dead lanes
# contribute exactly 0.0 and chunked prefill reproduces the monolithic
# blockwise attention (DESIGN.md §7).
# --------------------------------------------------------------------------

def _pad1(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad axis 1 of ``x`` to length ``n``."""
    if x.shape[1] >= n:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], n - x.shape[1], *x.shape[2:]))], dim=1)


def chunk_attend(
    cache: Cache,
    pages_row: torch.Tensor,  # (maxp,) claimed slab ids for this slot (−1 pad)
    q: torch.Tensor,  # (1, Cb, H, Dh) chunk queries
    k_chunk: torch.Tensor,  # (1, Cb, KH, Dh) chunk keys (pre-scatter)
    v_chunk: torch.Tensor,
    t0: int,  # tokens already prefilled (the chunk's global offset)
    live: int,  # live tokens in this chunk (≤ Cb; the rest is padding)
    cfg: ModelConfig,
    first: bool = False,
) -> torch.Tensor:
    """Chunk-of-prefill attention for one paged slot → (1, Cb, H, Dh).

    The prefix [0, t0) is gathered through ``pages_row`` and walked in
    ``attention_chunk`` steps, then the chunk attends itself causally.
    ``t0`` and ``live`` are host ints (the scheduler's plan).  The reference
    walks the whole ``maxp·T`` table width so that one trace serves every
    t0; PyTorch runs eagerly, so the port gathers and walks only the prefix
    chunks that hold a live lane.  The chunks it skips lie wholly at or past
    t0, after a first chunk that holds position 0: every lane of them is
    dead, their update is an exact no-op in the reference, and skipping
    them changes no bit.  ``first`` (t0 == 0) skips the walk, as there.
    """
    B, Sq, H, Dh = q.shape
    kh = cfg.n_kv_heads
    g = H // kh
    c = cfg.attention_chunk
    dev = q.device
    qr = q.reshape(B, Sq, kh, g, Dh).to(_F32) * (Dh ** -0.5)
    state = SoftmaxState(
        m=torch.full((B, Sq, kh, g), MASK_VALUE, dtype=_F32, device=dev),
        l=torch.zeros((B, Sq, kh, g), dtype=_F32, device=dev),
        acc=torch.zeros((B, Sq, kh, g, Dh), dtype=_F32, device=dev),
    )
    T = _pool_first(cache["k_pool"]).shape[-3]
    Skv = pages_row.shape[0] * T
    if Skv and not first and cfg.instrument:
        # the reference's fixed-width prefix gather: every page slot of k
        # and v walked, −1 = waste (counted as the reference walks it)
        live_p = (pages_row >= 0).sum()
        obs_device.record(obs_device.pack(dev, **{
            "paged_gather.launches": 2,
            "paged_gather.tiles": 2 * live_p,
            "paged_gather.masked_tiles": 2 * (pages_row.shape[0] - live_p),
        }))
    if Skv and not first and t0 > 0:
        cc = min(c, Skv)
        nch = math.ceil(min(t0, Skv) / cc)  # prefix chunks with a live lane
        npg = min(pages_row.shape[0], math.ceil(nch * cc / T))
        grp = pages_row[None, :npg]
        pk = _pad1(_gather_pool(cache["k_pool"], grp), nch * cc)
        pv = _pad1(_gather_pool(cache["v_pool"], grp), nch * cc)
        for ci in range(nch):
            kpos = ci * cc + torch.arange(cc, device=dev)
            live_m = (kpos < t0)[None, None, None, None, :]
            state = softmax_update(state, qr, pk[:, ci * cc:(ci + 1) * cc],
                                        pv[:, ci * cc:(ci + 1) * cc], live_m)
    # the chunk itself: causal, pad lanes (≥ live) dead
    co = min(c, Sq)
    n_own = math.ceil(Sq / co)
    kc_own, vc_own = _pad1(k_chunk, n_own * co), _pad1(v_chunk, n_own * co)
    qpos = torch.arange(Sq, device=dev)
    for ci in range(n_own):
        j = ci * co + torch.arange(co, device=dev)
        live_m = (j[None, :] < live) & (qpos[:, None] >= j[None, :])
        state = softmax_update(state, qr, kc_own[:, ci * co:(ci + 1) * co],
                                    vc_own[:, ci * co:(ci + 1) * co],
                                    live_m[None, :, None, None, :])
    out = state.acc / torch.clamp(state.l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def scatter_chunk(
    cache: Cache,
    pages_row: torch.Tensor,  # (maxp,) claimed slab ids (−1 pad)
    k_chunk: torch.Tensor,  # (1, Cb, KH, Dh)
    v_chunk: torch.Tensor,
    t0: int,
    live: int,
    cfg: ModelConfig,
) -> Cache:
    """Write a chunk's live K/V into the slot's claimed slabs, in place →
    ``cache``.  Dead lanes (padding, unclaimed page) drop."""
    T = _pool_first(cache["k_pool"]).shape[-3]
    maxp = pages_row.shape[0]
    Cb = k_chunk.shape[1]
    dev = k_chunk.device
    lane = torch.arange(Cb, device=dev)
    pos = t0 + lane
    slab = pages_row[torch.clamp(pos // T, 0, maxp - 1)]
    ok = (lane < live) & (slab >= 0) & (pos < maxp * T)
    slab = torch.where(ok, slab, -1)
    slot = pos % T
    if cfg.instrument:
        obs_device.record(obs_device.pack(dev, **{
            "slab_append.waves": 1,
            "slab_append.lanes": Cb,
            "slab_append.active_lanes": ok.sum(),
        }))
    _scatter_pool(cache["k_pool"], slab, slot, k_chunk[0])
    _scatter_pool(cache["v_pool"], slab, slot, v_chunk[0])
    return cache


# --------------------------------------------------------------------------
# prefill → cache (the phase transition: contiguous K/V sliced into buckets).
# --------------------------------------------------------------------------

def fill_from_prefill(cache: Cache, k_full: torch.Tensor, v_full: torch.Tensor) -> Cache:
    """Load (B, S, KH, Dh) prefill K/V into an (empty) cache slot, in place.

    static: the first min(S, capacity) positions.
    ggarray: bucket b receives the contiguous slice [start_b, start_b+len_b).
    paged: page p takes positions [p·T, (p+1)·T); rows whose page is
    unclaimed drop.
    """
    S = k_full.shape[1]
    if _is_paged(cache):
        T = _pool_first(cache["k_pool"]).shape[-3]
        maxp = cache["pages"].shape[-1]
        for p in range(min(-(-S // T), maxp)):
            slab = cache["pages"][:, p]  # −1 unclaimed ⇒ drop
            _scatter_slab(cache["k_pool"], slab, _pad1(k_full[:, p * T:(p + 1) * T], T))
            _scatter_slab(cache["v_pool"], slab, _pad1(v_full[:, p * T:(p + 1) * T], T))
        return cache
    if not _is_ggarray(cache):  # static: the first min(S, cap) positions
        n = min(S, cache["k"].shape[-3])
        cache["k"][:, :n] = k_full[:, :n]
        cache["v"][:, :n] = v_full[:, :n]
        return cache
    nlev = _levels(cache)
    b0 = cache["k0"].shape[-3]
    for lvl, (lo, size) in enumerate(zip(indexing.bucket_starts(b0, nlev),
                                         indexing.bucket_sizes(b0, nlev))):
        lo = int(lo)
        if lo >= S:
            break
        n = min(int(size), S - lo)
        cache[f"k{lvl}"][:, :n] = k_full[:, lo:lo + n]
        cache[f"v{lvl}"][:, :n] = v_full[:, lo:lo + n]
    return cache
