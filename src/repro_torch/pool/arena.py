"""Slab arena: one device pool, many logical growable arrays — port of
``repro.pool.arena``.

``SlabPool`` is a pre-carved pool of fixed-size slabs plus a device free
bitmap.  ``ArenaGGArray`` is the fleet of logical arrays living in it: each
array's storage is a *page table* of slab ids, with the GGArray bucket
structure kept as a geometric *grouping* of the table — level ``b`` of an
array is the sub-table ``pages[i, 2^b − 1 : 2^(b+1) − 1]``.  Growth is
"claim a slab": no copy, no per-array worst case.

``SlabArena`` is the host manager: claims and releases are planned against
host mirrors (``pool.planner``), the device state (pool, bitmap, page
tables) is updated at the call boundary, and the write itself is the slab
append K12.  Reads go through the paged gather (K8 for one extent, K9 for
several) and, for scalar items, the segmented gather K7.  Steady-state
appends read nothing from the device; a read happens only when pessimistic
bounds would otherwise claim a slab and the mask is not host-known.

``instrument=True`` hands each append's counter vector to the device
counter plane (``devctr``, K15) without reading it; ``check_invariants``
dumps a flight-recorder bundle (``flight``) naming the offending slabs
before its ``AssertionError`` propagates.

Differences from the reference: the pool is written in place (the reference
donates it); ``memory_space``/``dispatch`` are checked and have no effect.
``device=None`` means the card; pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import indexing
from repro_torch.kernels import common
from repro_torch.kernels.flatten import ops as flatten_ops
from repro_torch.kernels.paged import ops as paged_ops
from repro_torch.obs import DeviceCounterPlane, FlightRecorder, MetricsRegistry
from repro_torch.pool import extents as extents_mod
from repro_torch.pool.extents import ExtentPool
from repro_torch.pool.planner import PageBook, TenantPlanner, growth_amount

__all__ = [
    "SlabPool",
    "ExtentPool",
    "ArenaGGArray",
    "SlabArena",
    "init_pool",
    "grow_pool",
    "geometric_page_groups",
]


@dataclasses.dataclass(frozen=True)
class SlabPool:
    """The shared device pool: slab data + free-list bitmap."""

    data: torch.Tensor  # (n_slabs, slab_size, *item_shape)
    free: torch.Tensor  # (n_slabs,) bool — True = claimable

    @property
    def n_slabs(self) -> int:
        return self.data.shape[0]

    @property
    def slab_size(self) -> int:
        return self.data.shape[1]

    @property
    def item_shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape[2:])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def capacity_tokens(self) -> int:
        return self.n_slabs * self.slab_size


def init_pool(
    n_slabs: int,
    slab_size: int,
    item_shape: Sequence[int] = (),
    dtype: torch.dtype = torch.float32,
    *,
    device: "str | torch.device | None" = None,
) -> SlabPool:
    dev = _device.resolve(device)
    return SlabPool(
        data=torch.zeros((n_slabs, slab_size, *item_shape), dtype=dtype, device=dev),
        free=torch.ones((n_slabs,), dtype=torch.bool, device=dev),
    )


def grow_pool(pool: SlabPool, extra: int) -> SlabPool:
    """Append ``extra`` fresh slabs by realloc + copy (flat layout) — the
    copy the extent layout removes.  Page tables are indices, so no table
    changes."""
    dev = pool.data.device
    return SlabPool(
        data=torch.cat([pool.data, torch.zeros((extra, *pool.data.shape[1:]), dtype=pool.dtype,
                                               device=dev)]),
        free=torch.cat([pool.free, torch.ones((extra,), dtype=torch.bool, device=dev)]),
    )


@dataclasses.dataclass(frozen=True)
class ArenaGGArray:
    """The fleet's logical arrays: per-array page tables + sizes.

    ``pages[i, p]`` is the slab holding array ``i``'s positions
    ``[p·T, (p+1)·T)``; −1 = unclaimed.
    """

    pages: torch.Tensor  # (narrays, max_pages) int32
    sizes: torch.Tensor  # (narrays,) int32

    @property
    def narrays(self) -> int:
        return self.pages.shape[0]

    @property
    def max_pages(self) -> int:
        return self.pages.shape[1]


def geometric_page_groups(max_pages: int) -> list[tuple[int, int]]:
    """GGArray bucket levels as page-table slices: [(2^b−1, 2^(b+1)−1), …)."""
    groups = []
    lo = 0
    width = 1
    while lo < max_pages:
        groups.append((lo, min(lo + width, max_pages)))
        lo += width
        width *= 2
    return groups


class SlabArena:
    """Host manager for one pool + ``narrays`` logical growable arrays."""

    def __init__(
        self,
        narrays: int,
        slab_size: int,
        *,
        item_shape: Sequence[int] = (),
        dtype: torch.dtype = torch.float32,
        initial_slabs: int = 0,
        max_pages: int = 1,
        quota_slabs: int | None = None,
        memory_space: str | None = None,
        dispatch: str = "auto",
        grow_chunk: int | str = 1,
        instrument: bool = False,
        registry: MetricsRegistry | None = None,
        device: "str | torch.device | None" = None,
    ):
        """``initial_slabs`` pre-carves the pool; ``grow_chunk`` is the
        growth policy on exhaustion:

        * int floor or ``"geometric"`` — flat single-extent layout, growth
          reallocs and copies the pool (``pool.planner.growth_amount``);
        * ``"doubling"`` / ``"tz"`` — segmented extents (``pool.extents``):
          growth appends a fresh extent, **zero pool bytes copied**
          (``pool_copied_bytes`` stays 0).

        The reference's ``append_method`` (the Pallas kernel or its jnp
        oracle) has no counterpart: the pool's device decides.
        """
        if slab_size < 1:
            raise ValueError("slab_size must be >= 1")
        common.check_memory_space(memory_space)
        common.check_dispatch(dispatch)
        dev = _device.resolve(device)
        self.device = dev
        self.pool = extents_mod.init_extent_pool(
            initial_slabs, slab_size, item_shape, dtype, device=dev
        )
        self.arr = ArenaGGArray(
            pages=torch.full((narrays, max(max_pages, 1)), -1, dtype=torch.int32, device=dev),
            sizes=torch.zeros((narrays,), dtype=torch.int32, device=dev),
        )
        # one shared host book: allocator + page counts + slab→page mapping
        self.book = PageBook(narrays, quota_slabs=quota_slabs)
        self.book.grow(initial_slabs)
        self.book.max_pages = max(max_pages, 1)
        self.planner = TenantPlanner(narrays)
        self.memory_space = memory_space
        self.dispatch = dispatch
        self.grow_chunk = grow_chunk
        self.instrument = instrument
        # device mirrors of owners/bases, refreshed only when claims change
        self._tables_dev: tuple[torch.Tensor, torch.Tensor] | None = None
        self.registry = registry if registry is not None else MetricsRegistry()
        reg = self.registry
        reg.counter("arena.appends", "wave appends executed")
        reg.counter("pool.grow_events", "pool capacity growth events")
        reg.counter("pool.table_grow_events", "page-table widenings")
        # bytes of live pool data copied by growth: 0 under the extent
        # schedules, O(log n)·pool under "geometric", O(grows)·pool under int
        reg.counter("pool.copied_bytes", "pool bytes memcpy'd by realloc growth")
        reg.gauge("pool.live_tokens_ub", "host upper bound on live elements")
        reg.gauge_fn("pool.host_syncs", lambda: self.planner.host_syncs,
                     "planner device contacts")
        reg.gauge_fn("pool.capacity_tokens", lambda: self.capacity_tokens)
        reg.gauge_fn("pool.live_slabs", lambda: self.alloc.live_count)
        reg.gauge_fn("pool.free_slabs", lambda: self.alloc.free_count)
        reg.gauge_fn("pool.reserved_slabs", lambda: self.alloc.reserved_total)
        reg.gauge_fn("pool.utilization", self.utilization)
        # device counter plane + flight recorder (DESIGN.md §9.x/§9.y):
        # instrumented appends hand their counter vector to the plane;
        # invariant violations dump a postmortem bundle before raising
        self.devctr = DeviceCounterPlane(reg)
        self.flight = FlightRecorder()

    @property
    def alloc(self):
        return self.book.alloc

    # ---- stat attributes (reads of the registry) -------------------------
    @property
    def appends(self) -> int:
        return int(self.registry.counter("arena.appends").total())

    @property
    def pool_grow_events(self) -> int:
        return int(self.registry.counter("pool.grow_events").total())

    @property
    def table_grow_events(self) -> int:
        return int(self.registry.counter("pool.table_grow_events").total())

    @property
    def peak_live_ub(self) -> int:
        return int(self.registry.gauge("pool.live_tokens_ub").hwm())

    @property
    def pool_copied_bytes(self) -> int:
        return int(self.registry.counter("pool.copied_bytes").total())

    # ---- geometry --------------------------------------------------------
    @property
    def narrays(self) -> int:
        return self.arr.narrays

    @property
    def slab_size(self) -> int:
        return self.pool.slab_size

    @property
    def item_shape(self) -> tuple[int, ...]:
        return self.pool.item_shape

    @property
    def capacity_tokens(self) -> int:
        return self.pool.capacity_tokens

    @property
    def live_tokens_ub(self) -> int:
        """Host upper bound on live elements (exact under host-known masks)."""
        return int(self.planner.ub.sum())

    @property
    def host_syncs(self) -> int:
        return self.planner.host_syncs

    def utilization(self) -> float:
        cap = self.capacity_tokens
        return self.live_tokens_ub / cap if cap else 0.0

    # nblocks/sizes aliases — the wave-interface surface TwoPhasePipeline uses
    @property
    def nblocks(self) -> int:
        return self.narrays

    @property
    def sizes(self) -> torch.Tensor:
        return self.arr.sizes

    def memory_elems(self) -> int:
        return self.capacity_tokens

    # ---- slab claiming ---------------------------------------------------
    def _ensure_table_width(self, need: int) -> None:
        widened = self.book.widen(need)  # geometric: O(log) restructures
        if widened is None:
            return
        old, new = widened
        pad = torch.full((self.narrays, new - old), -1, dtype=torch.int32, device=self.device)
        self.arr = dataclasses.replace(self.arr, pages=torch.cat([self.arr.pages, pad], dim=1))
        self.registry.counter("pool.table_grow_events").inc()

    def _ensure_slabs(self, k: int) -> None:
        short = self.book.shortfall(k)
        if short == 0:
            return
        reserved = self.alloc.reserved_total
        if extents_mod.is_extent_schedule(self.grow_chunk):
            new_sizes = extents_mod.plan_extents(
                self.pool.extent_sizes, short, self.grow_chunk, reserved=reserved
            )
            self.pool = extents_mod.grow_extents(self.pool, new_sizes)
            extra = sum(new_sizes)
        else:
            extra = growth_amount(self.pool.n_slabs, short, self.grow_chunk, reserved=reserved)
            item = int(np.prod(self.item_shape, dtype=np.int64))
            self.registry.counter("pool.copied_bytes").inc(
                self.pool.capacity_tokens * item * self.pool.extents[0].element_size()
            )
            self.pool = extents_mod.grow_flat(self.pool, extra)
        self.book.grow(extra)
        self.registry.counter("pool.grow_events").inc()

    def _claim(self, per_tenant: np.ndarray) -> None:
        """Claim ``per_tenant[i]`` fresh slabs for each array (one scatter)."""
        total = int(per_tenant.sum())
        if total == 0:
            return
        self._ensure_table_width(int((self.book.npages + per_tenant).max()))
        self._ensure_slabs(total)
        rows, cols, ids = [], [], []
        for tenant in np.flatnonzero(per_tenant):
            k = int(per_tenant[tenant])
            got, page0 = self.book.claim(int(tenant), k)
            rows.extend([int(tenant)] * k)
            cols.extend(range(page0, page0 + k))
            ids.extend(int(s) for s in got)
        dev = self.device
        rows_t = common.to_device(np.asarray(rows, np.int64), dev)
        cols_t = common.to_device(np.asarray(cols, np.int64), dev)
        ids_t = common.to_device(np.asarray(ids, np.int64), dev)
        self.arr.pages[rows_t, cols_t] = ids_t.to(torch.int32)
        self.pool.free[ids_t] = False
        self._tables_dev = None  # ownership changed: refresh kernel tables

    def _owner_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._tables_dev is None:
            self._tables_dev = (
                common.to_device(self.book.alloc.owner.astype(np.int32), self.device),
                common.to_device((self.book.page_of_slab * self.slab_size).astype(np.int32),
                                 self.device),
            )
        return self._tables_dev

    def _pool_arg(self):
        """The pool as the paged ops take it: a flat tensor for the
        single-extent layout, a tuple of extents for the segmented ones."""
        if self.pool.n_extents == 1:
            return self.pool.extents[0]
        return self.pool.extents

    # ---- the hot path ----------------------------------------------------
    def append(self, elems: Any, mask: Any = None) -> torch.Tensor:
        """Wave append: up to ``m`` elements per array → positions (−1 masked).

        ``elems: (narrays, m, *item_shape)``.  Host bounds advance by exact
        lane counts when ``mask`` is host-known (numpy), by ``m`` otherwise;
        a device read happens only when pessimism alone would claim a slab.
        The pool is written in place.
        """
        dev = self.device
        elems = common.to_device(elems, dev)
        n, m = elems.shape[:2]
        if n != self.narrays:
            raise ValueError(f"elems rows {n} != narrays {self.narrays}")
        if m == 0:
            return torch.zeros((n, 0), dtype=torch.int32, device=dev)
        T = self.slab_size
        counts, exact = self.planner.plan(m, mask)
        need = -(-(self.planner.ub + counts) // T)  # pages needed per array
        delta = np.maximum(need - self.book.npages, 0)
        if delta.any() and not exact:
            # PLAN: one vector read re-seeds the bounds before claiming
            self.planner.sync(self.arr.sizes)
            need = -(-(self.planner.ub + counts) // T)
            delta = np.maximum(need - self.book.npages, 0)
        self._claim(delta)
        owners, bases = self._owner_tables()
        if mask is None:
            mask_dev = torch.ones((n, m), dtype=torch.bool, device=dev)
        else:
            mask_dev = common.to_device(mask, dev)
            if mask_dev.dtype != torch.bool:
                mask_dev = mask_dev != 0
        _, sizes, pos, *vec = paged_ops.slab_append(
            self._pool_arg(), owners, bases, self.arr.sizes, elems.to(self.pool.dtype),
            mask_dev, memory_space=self.memory_space, dispatch=self.dispatch,
            instrument=self.instrument,
        )
        if vec:
            self.devctr.add(vec[0])  # a list append — no transfer
        self.arr = dataclasses.replace(self.arr, sizes=sizes)
        self.planner.advance(counts)
        self.registry.counter("arena.appends").inc()
        self.registry.gauge("pool.live_tokens_ub").set(self.live_tokens_ub)
        return pos

    # ---- reclamation -----------------------------------------------------
    def release(self, tenant: int) -> int:
        """Free every slab of array ``tenant`` → count.  The slabs go back on
        the free list (host + device bitmap) and are reused by later claims
        *before* the pool grows."""
        ids = self.book.release(tenant)
        if len(ids):
            self.pool.free[common.to_device(ids.astype(np.int64), self.device)] = True
            self._tables_dev = None
        pages = self.arr.pages.clone()
        pages[tenant] = -1
        sizes = self.arr.sizes.clone()
        sizes[tenant] = 0
        self.arr = ArenaGGArray(pages=pages, sizes=sizes)
        self.planner.reset(tenant)
        return len(ids)

    # ---- reads -----------------------------------------------------------
    def logical_view(self) -> torch.Tensor:
        """(narrays, max_pages·T, *item) contiguous views (paged gather)."""
        return paged_ops.paged_gather(self._pool_arg(), self.arr.pages,
                                      memory_space=self.memory_space)

    def flatten(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """→ (flat, total, block_starts) in block-major global order.

        The arena's freeze: the paged gather (K8/K9) materialises each
        array's compact row, then the segmented gather K7 (scalar items) or
        a plain scatter (other items) applies the global order.
        """
        sizes = self.arr.sizes
        starts = indexing.block_starts(sizes).to(torch.int32)
        total = torch.sum(sizes, dtype=torch.int32)
        cap_pb = self.arr.max_pages * self.slab_size
        if self.pool.n_slabs == 0:
            flat = torch.zeros((self.narrays * cap_pb, *self.item_shape),
                               dtype=self.pool.dtype, device=self.device)
            return flat, total, starts
        compact = self.logical_view()
        if not self.item_shape:
            flat = flatten_ops.segmented_gather(compact, starts, starts + sizes.to(torch.int32))
            return flat, total, starts
        cap = self.narrays * cap_pb
        posn = torch.arange(cap_pb, dtype=torch.int32, device=self.device)[None, :]
        live = posn < sizes[:, None]
        tgt = starts[:, None] + posn
        flat = torch.zeros((cap, *self.item_shape), dtype=self.pool.dtype, device=self.device)
        common.put_drop_(flat, (tgt,), live, compact)
        return flat, total, starts

    # ---- verification (tests and debugging only: reads the device) -------
    def _flight_dump(self, reason: str, error: BaseException | None = None,
                     invariant: dict | None = None) -> None:
        """Postmortem bundle on invariant failure; never raises or re-dumps."""
        if error is not None and getattr(error, "_flightrec_dumped", False):
            return
        try:
            state = {
                "narrays": self.narrays,
                "slab_size": self.slab_size,
                "extent_sizes": list(self.pool.extent_sizes),
                "n_slabs": self.pool.n_slabs,
                "free_ids": np.flatnonzero(self.alloc.free).tolist(),
                "refcounts": np.asarray(self.alloc.refcount).tolist(),
                "npages": np.asarray(self.book.npages).tolist(),
                "live_ub": np.asarray(self.planner.ub).tolist(),
                "page_tables": [[int(s) for s in self.book.pages_of[i]]
                                for i in range(self.narrays)],
            }
            if invariant:
                state["invariant"] = dict(invariant)
            self.flight.dump(
                reason=reason, error=error, state=state,
                metrics=self.registry.snapshot(),
                device_counters=self.devctr.counters(),
            )
        except Exception:
            return
        if error is not None:
            try:
                error._flightrec_dumped = True
            except Exception:
                pass

    def check_invariants(self) -> dict:
        """Cross-check the device state against the host mirrors; raises
        ``AssertionError`` on drift, after dumping a flight-recorder bundle
        (offending slab ids, page tables, refcounts) — DESIGN.md §9.y."""
        try:
            return self._check_invariants_inner()
        except AssertionError as e:
            self._flight_dump("arena_invariant", e)
            raise

    def _check_invariants_inner(self) -> dict:
        free_dev = self.pool.free.cpu().numpy()
        pages_dev = self.arr.pages.cpu().numpy()
        sizes_dev = self.arr.sizes.cpu().numpy()
        assert (free_dev == self.alloc.free).all(), "device bitmap drifted"
        # two-level table round-trip: base[ext_of[s]] + off_of[s] == s
        ext_of, off_of = extents_mod.slab_tables(self.pool.extent_sizes)
        assert len(ext_of) == self.pool.n_slabs == len(free_dev), (
            "extent sizes disagree with the free bitmap"
        )
        if len(ext_of):
            bases = np.asarray(self.pool.bases)
            assert (bases[ext_of] + off_of == np.arange(self.pool.n_slabs)).all(), (
                "two-level table does not round-trip"
            )
        self.alloc.check()
        claimed = pages_dev[pages_dev >= 0]
        assert not free_dev[claimed].any() if len(claimed) else True, (
            "free slab present in a page table"
        )
        # every reference on a claimed slab is exactly one live page-table
        # entry — the arena never aliases, so this also rules out double
        # assignment and orphaned claims
        refs = np.zeros((self.alloc.n_slabs,), np.int64)
        if len(claimed):
            vals, counts = np.unique(claimed, return_counts=True)
            refs[vals] = counts
        bad = np.flatnonzero(refs != self.alloc.refcount)
        if len(bad):
            err = AssertionError(f"refcounts drift from page tables: {bad}")
            self._flight_dump(
                "refcount_mismatch", err,
                invariant={
                    "check": "refcount_conservation",
                    "offending_slabs": bad.tolist(),
                    "expected_refcount": refs[bad].tolist(),
                    "actual_refcount": np.asarray(self.alloc.refcount)[bad].tolist(),
                },
            )
            raise err
        for i in range(self.narrays):
            npg = int(self.book.npages[i])
            assert (pages_dev[i, :npg] >= 0).all(), f"array {i}: hole in table"
            assert (pages_dev[i, npg:] == -1).all(), f"array {i}: stray pages"
            assert sizes_dev[i] <= npg * self.slab_size, f"array {i}: overflow"
            assert sizes_dev[i] <= self.planner.ub[i], f"array {i}: bound lies"
        return {
            "live_slabs": self.alloc.live_count,
            "free_slabs": self.alloc.free_count,
            "live_tokens": int(sizes_dev.sum()),
            "capacity_tokens": self.capacity_tokens,
            "reuse_claims": self.alloc.reuse_claims,
            "grown_slabs": self.alloc.grown_slabs,
        }
