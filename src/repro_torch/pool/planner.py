"""Host-side slab accounting: free-list allocator + per-tenant planner —
port of ``repro.pool.planner`` (host numpy code, the same semantics).

The allocator is the host mirror of the pool's device free-list bitmap
(``SlabPool.free``): claims and releases are pure host bookkeeping (the
device bitmap is updated by the arena in the same program-boundary step), so
slab allocation never reads the device — the arena analog of the
``CapacityPlanner`` contract (DESIGN.md §2/§4).

``TenantPlanner`` extends ``core.ggarray.CapacityPlanner``'s bound tracking
to a *fleet*: one upper bound per logical array, advanced by exact per-array
lane counts when the append mask is host-known, plus an optional per-tenant
slab quota — the admission-control knob a multi-tenant serving pool needs so
one runaway sequence cannot starve the others.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = [
    "SlabAllocator",
    "TenantPlanner",
    "PageBook",
    "QuotaExceeded",
    "growth_amount",
]


def growth_amount(
    n_slabs: int, short: int, grow_chunk: int | str, *, reserved: int = 0
) -> int:
    """Slabs to add when the free list is ``short`` of a claim.

    ``grow_chunk`` is the over-provisioning policy:

    * an int ``c`` — demand growth with a floor: add ``max(short, c)``
      (``1`` = exact demand, the tight-capacity default);
    * ``"geometric"`` — double the pool: add
      ``max(short, n_slabs + reserved, 1)``, so a fleet that keeps growing
      pays **O(log n_slabs)** realloc copies total instead of one per growth
      wave (Tarjan & Zwick amortization; asserted in
      ``tests/pool/test_arena.py``).

    ``reserved`` is the count of reserved-but-unclaimed slabs from in-flight
    chunked prefills (``SlabAllocator.reserved_total``): the doubling base
    counts them as committed demand, so a growth sized while reservations
    are outstanding leaves headroom for the claims that convert them — a
    grow sized off the free list alone could be exhausted again within the
    same scheduler step (the double-grow the engine tests assert against).

    Pre-carving (``SlabArena(initial_slabs=...)`` / a pool sized to the
    expected high-water mark at engine start) composes with either policy —
    growth only begins once the pre-carve is exhausted.
    """
    if grow_chunk == "geometric":
        return max(short, n_slabs + reserved, 1)
    return max(short, int(grow_chunk))


class QuotaExceeded(RuntimeError):
    """A claim would push a tenant past its per-tenant slab quota."""


class SlabAllocator:
    """Lowest-index-first free list over ``n_slabs`` pool slots.

    Lowest-first claiming makes reuse the default: released slabs always sit
    below freshly grown ones, so the pool only grows once every freed slab
    is back in use (the reclamation invariant the property tests assert).

    Slabs are **refcounted** (DESIGN.md §10): ``claim`` starts a slab at one
    reference, ``addref`` lets a second page table (or the prefix cache)
    alias it, and ``release`` drops one reference per id — the slab only
    returns to the free bitmap when the *last* reference goes.  ``owner``
    names the tenant charged for the slab while its first claimant still
    holds a reference; a slab that outlives its claimant (aliases remain)
    is marked ``SHARED`` so quota accounting stops billing the departed
    tenant.
    """

    SHARED = -2  # owner sentinel: claimed, but the first claimant released

    def __init__(self, n_slabs: int = 0, *, quota_slabs: int | None = None):
        self.free = np.ones((n_slabs,), bool)
        self.owner = np.full((n_slabs,), -1, np.int32)  # tenant per slab
        self.refcount = np.zeros((n_slabs,), np.int32)  # references per slab
        self.quota_slabs = quota_slabs
        self.claims = 0
        self.reuse_claims = 0  # claims satisfied by a previously released slab
        self.releases = 0
        self.alias_claims = 0  # addref calls — shared-page references taken
        self.grown_slabs = 0
        self.peak_live = 0
        # Reservation ledger: slab *counts* (not ids) promised to tenants with
        # in-flight chunked prefills.  Reserved counts are subtracted from the
        # availability other claims see, so decode growth can never starve a
        # prefill that was already admitted (DESIGN.md §7 invariant).
        self.reserved: dict[int, int] = {}
        self._ever_released = np.zeros((n_slabs,), bool)

    @property
    def n_slabs(self) -> int:
        return len(self.free)

    @property
    def free_count(self) -> int:
        return int(self.free.sum())

    @property
    def live_count(self) -> int:
        return self.n_slabs - self.free_count

    @property
    def reserved_total(self) -> int:
        return sum(self.reserved.values())

    def tenant_slabs(self, tenant: int) -> int:
        return int((self.owner == tenant).sum())

    def shortfall(self, k: int, *, tenant: int | None = None) -> int:
        """Slabs the pool must grow by before ``claim(·, k)`` can succeed.

        Outstanding reservations are unavailable to everyone except their own
        tenant: pass ``tenant`` to count that tenant's reservation as usable
        (the claim-from-reservation path).
        """
        avail = self.free_count - self.reserved_total
        if tenant is not None:
            avail += self.reserved.get(tenant, 0)
        return max(k - avail, 0)

    def reserve(self, tenant: int, k: int) -> None:
        """Promise ``k`` slabs to ``tenant`` (quota-checked, ids unassigned).

        The pool must already cover the reservation (grow on
        ``shortfall(k)`` first, like a claim).
        """
        if k == 0:
            return
        if self.quota_slabs is not None:
            held = self.tenant_slabs(tenant) + self.reserved.get(tenant, 0)
            if held + k > self.quota_slabs:
                raise QuotaExceeded(
                    f"tenant {tenant}: {held} + {k} slabs > quota "
                    f"{self.quota_slabs}"
                )
        if self.shortfall(k) > 0:
            raise RuntimeError(
                f"cannot reserve {k}: only "
                f"{self.free_count - self.reserved_total} unreserved slabs free"
            )
        self.reserved[tenant] = self.reserved.get(tenant, 0) + k

    def unreserve(self, tenant: int, k: int | None = None) -> int:
        """Cancel (part of) a tenant's reservation → slabs returned."""
        held = self.reserved.get(tenant, 0)
        k = held if k is None else min(k, held)
        if k:
            self.reserved[tenant] = held - k
            if self.reserved[tenant] == 0:
                del self.reserved[tenant]
        return k

    def grow(self, extra: int) -> None:
        self.free = np.concatenate([self.free, np.ones((extra,), bool)])
        self.owner = np.concatenate([self.owner, np.full((extra,), -1, np.int32)])
        self.refcount = np.concatenate(
            [self.refcount, np.zeros((extra,), np.int32)]
        )
        self._ever_released = np.concatenate(
            [self._ever_released, np.zeros((extra,), bool)]
        )
        self.grown_slabs += extra

    def claim(
        self, tenant: int, k: int, *, from_reservation: bool = False
    ) -> np.ndarray:
        """Claim ``k`` slabs for ``tenant`` → int32 slab ids (lowest first).

        ``from_reservation`` draws down the tenant's reservation first (that
        part was quota-checked at ``reserve`` time); any excess is treated as
        a fresh claim.
        """
        if k == 0:
            return np.zeros((0,), np.int32)
        from_res = min(k, self.reserved.get(tenant, 0)) if from_reservation else 0
        fresh = k - from_res
        if self.quota_slabs is not None and fresh > 0:
            held = self.tenant_slabs(tenant) + self.reserved.get(tenant, 0)
            if held + fresh > self.quota_slabs:
                raise QuotaExceeded(
                    f"tenant {tenant}: {held} + {fresh} slabs "
                    f"> quota {self.quota_slabs}"
                )
        ids = np.flatnonzero(self.free)[:k].astype(np.int32)
        if len(ids) < k:
            raise RuntimeError(
                f"free list exhausted: want {k}, have {len(ids)} "
                "(grow the pool first — see SlabArena._ensure_slabs)"
            )
        self.unreserve(tenant, from_res)
        self.free[ids] = False
        self.owner[ids] = tenant
        self.refcount[ids] = 1
        self.claims += k
        self.reuse_claims += int(self._ever_released[ids].sum())
        self.peak_live = max(self.peak_live, self.live_count)
        return ids

    def addref(self, ids: np.ndarray) -> None:
        """Take one extra reference per id on already-claimed slabs.

        This is the aliasing primitive: a second page table (or the prefix
        cache) pointing at a claimed slab holds a reference, and the slab
        stays out of the free list until every holder releases.  Aliasing a
        free slab is a bug — the data it indexes is gone.
        """
        ids = np.asarray(ids, np.int32)
        if len(ids) == 0:
            return
        if self.free[ids].any():
            raise RuntimeError(f"alias of free slab: {ids[self.free[ids]]}")
        np.add.at(self.refcount, ids, 1)
        self.alias_claims += len(ids)

    def release(
        self, ids: np.ndarray, *, tenant: int | None = None
    ) -> np.ndarray:
        """Drop one reference per id → the ids actually freed.

        Shared slabs (refcount > 1) survive: the free bitmap, ``releases``
        counter, and reuse tracking only move when a slab's **last**
        reference goes.  ``tenant`` marks surviving slabs charged to that
        tenant as :data:`SHARED`, so a departed claimant's quota is no
        longer billed for pages its aliases keep alive.
        """
        ids = np.asarray(ids, np.int32)
        if len(ids) == 0:
            return ids
        if self.free[ids].any():
            raise RuntimeError(f"double free: {ids[self.free[ids]]}")
        np.subtract.at(self.refcount, ids, 1)
        if (self.refcount[ids] < 0).any():
            raise RuntimeError(
                f"negative refcount: {ids[self.refcount[ids] < 0]}"
            )
        freed = np.unique(ids[self.refcount[ids] == 0]).astype(np.int32)
        self.free[freed] = True
        self.owner[freed] = -1
        self._ever_released[freed] = True
        self.releases += len(freed)
        if tenant is not None:
            kept = ids[self.refcount[ids] > 0]
            kept = kept[self.owner[kept] == tenant]
            self.owner[kept] = self.SHARED
        return freed

    def release_tenant(self, tenant: int) -> np.ndarray:
        """Release every slab still *charged to* ``tenant`` → the freed ids.

        Owner-based, so it only sees exclusively-held slabs; sharing callers
        (``PageBook.release``) release their page list instead.
        """
        ids = np.flatnonzero(self.owner == tenant).astype(np.int32)
        return self.release(ids, tenant=tenant)

    def check(self) -> None:
        """Free-xor-claimed, refcount, and reservation-coverage invariants."""
        bad = self.free & (self.owner != -1)
        assert not bad.any(), f"slabs both free and owned: {np.flatnonzero(bad)}"
        bad = ~self.free & (self.owner == -1)
        assert not bad.any(), f"slabs claimed but unowned: {np.flatnonzero(bad)}"
        bad = self.free & (self.refcount != 0)
        assert not bad.any(), f"free slabs with references: {np.flatnonzero(bad)}"
        bad = ~self.free & (self.refcount < 1)
        assert not bad.any(), (
            f"claimed slabs without references: {np.flatnonzero(bad)}"
        )
        assert all(v > 0 for v in self.reserved.values()), self.reserved
        assert self.reserved_total <= self.free_count, (
            f"reservations ({self.reserved_total}) exceed free slabs "
            f"({self.free_count}) — a claim ate reserved capacity"
        )


class PageBook:
    """Host-side page-table bookkeeping shared by the arena and the engine.

    One :class:`SlabAllocator` plus the pieces every page-table owner needs
    kept consistent with it: per-tenant page counts, the slab→page mapping
    (claim order), and the geometric table-width policy.  Pure host state —
    callers apply the matching device updates (pool growth, free bitmap,
    page-table scatters) at the program boundary.  Keeping this in one
    place is what keeps ``SlabArena`` and ``BatchEngine`` free-list
    semantics identical (reuse-before-grow, page0 offsetting, O(log) table
    restructures).
    """

    def __init__(self, ntenants: int, *, quota_slabs: int | None = None):
        self.alloc = SlabAllocator(0, quota_slabs=quota_slabs)
        self.npages = np.zeros((ntenants,), np.int64)
        self.page_of_slab = np.full((0,), -1, np.int64)
        self.max_pages = 1
        # Per-tenant page lists (slab id per page, page order).  With slab
        # sharing a slab can sit in several tables at different page indices,
        # so the flat ``page_of_slab`` inverse is only authoritative for
        # exclusively-held slabs (the arena's kernel tables); these lists
        # are the source of truth for ordering and release.
        self.pages_of: list[list[int]] = [[] for _ in range(ntenants)]

    def grow(self, extra: int) -> None:
        """Record ``extra`` fresh slabs (caller grew the device pool)."""
        self.alloc.grow(extra)
        self.page_of_slab = np.concatenate(
            [self.page_of_slab, np.full((extra,), -1, np.int64)]
        )

    def shortfall(self, k: int, *, tenant: int | None = None) -> int:
        return self.alloc.shortfall(k, tenant=tenant)

    @property
    def reserved_total(self) -> int:
        """Reserved-but-unclaimed slabs — counted when sizing a new extent
        (``growth_amount(..., reserved=...)`` / ``extents.plan_extents``)."""
        return self.alloc.reserved_total

    def reserve(self, tenant: int, k: int) -> None:
        """Promise ``k`` slabs to ``tenant`` (see ``SlabAllocator.reserve``)."""
        self.alloc.reserve(tenant, k)

    def unreserve(self, tenant: int, k: int | None = None) -> int:
        return self.alloc.unreserve(tenant, k)

    def widen(self, need: int) -> tuple[int, int] | None:
        """Geometric table widening → (old, new) widths, or None if covered."""
        if need <= self.max_pages:
            return None
        old, self.max_pages = self.max_pages, max(need, 2 * self.max_pages)
        return old, self.max_pages

    def claim(
        self, tenant: int, k: int, *, from_reservation: bool = False
    ) -> tuple[np.ndarray, int]:
        """Claim ``k`` slabs → (ids, first page index).  Reuse-first; the
        free list must already cover ``k`` (grow the pool on shortfall)."""
        ids = self.alloc.claim(tenant, k, from_reservation=from_reservation)
        page0 = int(self.npages[tenant])
        self.page_of_slab[ids] = page0 + np.arange(k)
        self.pages_of[tenant].extend(int(i) for i in ids)
        self.npages[tenant] += k
        return ids, page0

    def adopt(self, tenant: int, ids: np.ndarray) -> int:
        """Append pre-referenced slabs to ``tenant``'s table → first page.

        The references must already be held (a prefix-cache match pins its
        slabs with ``alloc.addref`` before admission); ``adopt`` just
        transfers them into the page table.  Use :meth:`alias` when the
        reference still needs taking.
        """
        ids = np.asarray(ids, np.int32)
        page0 = int(self.npages[tenant])
        self.pages_of[tenant].extend(int(i) for i in ids)
        self.npages[tenant] += len(ids)
        return page0

    def alias(self, tenant: int, ids: np.ndarray) -> int:
        """Point ``tenant``'s next pages at already-claimed slabs
        (refcount++ per slab) → first page index."""
        ids = np.asarray(ids, np.int32)
        self.alloc.addref(ids)
        return self.adopt(tenant, ids)

    def replace(self, tenant: int, page: int, new_id: int) -> int:
        """Swap the slab at ``page`` of ``tenant``'s table → the old id.

        The copy-on-write primitive: ``new_id`` must already be claimed for
        ``tenant`` via ``alloc.claim`` (so its reference exists); the old
        slab's reference is **not** dropped here — the caller releases it
        after copying the data across.
        """
        old = self.pages_of[tenant][page]
        self.pages_of[tenant][page] = int(new_id)
        self.page_of_slab[new_id] = page
        return int(old)

    def release(self, tenant: int) -> np.ndarray:
        """Drop every page reference of ``tenant`` (and any leftover
        reservation) → the slabs actually freed (last reference gone)."""
        self.alloc.unreserve(tenant)
        ids = np.asarray(self.pages_of[tenant], np.int32)
        freed = self.alloc.release(ids, tenant=tenant)
        self.page_of_slab[freed] = -1
        self.pages_of[tenant] = []
        self.npages[tenant] = 0
        return freed

    def pages_in_order(self, tenant: int) -> np.ndarray:
        """``tenant``'s slab ids in page order."""
        return np.asarray(self.pages_of[tenant], np.int64)


class TenantPlanner:
    """Per-tenant size upper bounds — ``CapacityPlanner`` at fleet scale.

    ``plan(m, mask)`` advances each tenant's bound (exactly, when ``mask``
    is a host array; by ``m`` otherwise) and returns the per-tenant counts;
    ``sync(sizes)`` re-seeds the bounds from a device read when pessimism
    would otherwise claim slabs the data doesn't need.

    Any ``torch.Tensor`` mask, on any device, plays the role of the
    reference's ``jax.Array``: it is not host-known, and reading it would be
    the sync the planner exists to avoid.  numpy arrays and lists are
    host-known.
    """

    def __init__(self, ntenants: int):
        self.ub = np.zeros((ntenants,), np.int64)
        self.host_syncs = 0

    @staticmethod
    def host_counts(mask: Any, ntenants: int, m: int) -> np.ndarray | None:
        if mask is None:
            return np.full((ntenants,), m, np.int64)
        if isinstance(mask, torch.Tensor):
            return None  # device mask: converting it would be the sync
        arr = np.asarray(mask)
        if arr.ndim != 2 or arr.shape[0] != ntenants:
            return None
        return (arr != 0).sum(axis=1).astype(np.int64)

    def plan(self, m: int, mask: Any = None) -> tuple[np.ndarray, bool]:
        """→ (per-tenant advance, exact?) without touching the bounds."""
        counts = self.host_counts(mask, len(self.ub), m)
        if counts is None:
            return np.full((len(self.ub),), m, np.int64), False
        return counts, mask is None or not isinstance(mask, torch.Tensor)

    def advance(self, counts: np.ndarray) -> None:
        self.ub += counts

    def sync(self, sizes: torch.Tensor) -> np.ndarray:
        """Re-seed bounds from the device sizes vector (one transfer)."""
        self.ub = sizes.cpu().numpy().astype(np.int64)
        self.host_syncs += 1
        return self.ub

    def reset(self, tenant: int) -> None:
        self.ub[tenant] = 0
