"""Two-phase runtime: grow → freeze → static (paper §VI.D), port of ``repro.runtime.phases``.

* **GROW** — the pipeline owns a :class:`repro_torch.core.ggarray.GGArray`;
  ``append`` runs the amortized growth protocol (``CapacityPlanner.reserve``
  + the in-place ``gg.append`` — block-local, zero host reads in the steady
  state).
* **freeze()** — one flatten into a contiguous, globally ordered
  :class:`FrozenArray`: the segmented gather (K7), reading the bucket levels.
* **FROZEN** — reads are direct indexing; ``map_frozen`` runs static work
  over the contiguous buffer.
* **thaw()** — back to GROW: zero-copy by default (the bucket chain is
  intact), or ``rebalance=True`` to redistribute the frozen contents evenly
  via ``from_flat``.

``from_arena`` runs the same lifecycle over a slab arena
(``repro_torch.pool.SlabArena``): append claims shared-pool slabs (K12),
freeze flattens through the page tables (K8/K9 + K7).
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import ggarray as gg
from repro_torch.kernels import common
from repro_torch.kernels.flatten import ops as flatten_ops
from repro_torch.obs import MetricsRegistry

__all__ = ["Phase", "PhaseError", "FrozenArray", "FreezeStats", "TwoPhasePipeline"]

FLATTEN_IMPLS = ("segmented", "dispatch", "core")


class Phase(str, enum.Enum):
    GROW = "grow"
    FROZEN = "frozen"


class PhaseError(RuntimeError):
    """Operation invoked in the wrong phase of the two-phase lifecycle."""


@dataclasses.dataclass(frozen=True)
class FrozenArray:
    """Contiguous block-major snapshot of a GGArray (the static-phase view).

    ``data`` is capacity-shaped; ``data[:size]`` are the live elements in
    global order, slots beyond are zero.  ``block_starts`` records where each
    source block's segment begins (the freeze-time prefix table).
    """

    data: torch.Tensor  # (capacity, *item_shape)
    size: torch.Tensor  # () int32 live element count
    block_starts: torch.Tensor  # (nblocks,) int32

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def item_shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def read(self, idx: Any) -> torch.Tensor:
        """O(1) contiguous read — no bucket walk, no block search."""
        return self.data[torch.as_tensor(idx, device=self.data.device)]

    def live_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.data.device) < self.size


class FreezeStats:
    """Lifecycle counters: a thin read view over a metrics registry.

    ``elements_frozen`` is **lazy**: each freeze adds the live-count scalar
    on the device (``Counter.add_lazy``), and the total is read only when
    the property is read — freezing never forces a host round-trip.
    ``host_syncs`` reads the live planner accounting.
    """

    def __init__(self, registry: MetricsRegistry | None = None, host_syncs_fn: Any = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._host_syncs_fn = host_syncs_fn

    def _ct(self, name: str) -> int:
        return int(self.registry.counter(name).total())

    @property
    def appends(self) -> int:
        return self._ct("runtime.appends")

    @property
    def grow_events(self) -> int:
        return self._ct("runtime.grow_events")

    @property
    def freezes(self) -> int:
        return self._ct("runtime.freezes")

    @property
    def thaws(self) -> int:
        return self._ct("runtime.thaws")

    @property
    def host_syncs(self) -> int:
        return int(self._host_syncs_fn()) if self._host_syncs_fn else 0

    @property
    def last_freeze_s(self) -> float:
        return float(self.registry.gauge("runtime.last_freeze_s").value())

    @property
    def total_freeze_s(self) -> float:
        return float(self.registry.counter("runtime.freeze_s").total())

    @property
    def elements_frozen(self) -> int:
        """Materialize the device-side accumulator (one explicit transfer)."""
        return int(self.registry.counter("runtime.elements_frozen").total())

    def __repr__(self) -> str:
        host = ", ".join(
            f"{n}={getattr(self, n)}"
            for n in ("appends", "grow_events", "freezes", "thaws",
                      "host_syncs", "last_freeze_s", "total_freeze_s")
        )
        return f"FreezeStats({host})"  # elements_frozen omitted: reading syncs


class TwoPhasePipeline:
    """Owns one GGArray across its grow → frozen → (re-grow) lifecycle.

    ``flatten_impl`` selects the freeze path: ``"segmented"`` (kernel K7 on
    the bucket levels, the default), ``"dispatch"`` (the reference's legacy ordering:
    K6, then the dispatch scatter K5a), or ``"core"`` (plain PyTorch scatter in
    ``core.ggarray`` — also the route whenever ``item_shape`` is non-scalar,
    which the kernels do not take).  ``memory_space`` selects a TPU tiling in
    the reference; it is checked and has no effect on the GPU.  ``device=None``
    means the card; pass ``device="cpu"`` for the CPU.
    """

    def __init__(
        self,
        nblocks: int = 8,
        b0: int = 8,
        item_shape: Sequence[int] = (),
        dtype: torch.dtype = torch.float32,
        nbuckets: int = 1,
        *,
        flatten_impl: str = "segmented",
        memory_space: str | None = None,
        registry: MetricsRegistry | None = None,
        device: "str | torch.device | None" = None,
    ):
        if flatten_impl not in FLATTEN_IMPLS:
            raise ValueError(f"flatten_impl {flatten_impl!r} not in {FLATTEN_IMPLS}")
        common.check_memory_space(memory_space)
        self._gg = gg.init(nblocks, b0, item_shape, dtype, nbuckets=nbuckets, device=device)
        self._arena = None
        self._frozen: FrozenArray | None = None
        self._phase = Phase.GROW
        self.flatten_impl = flatten_impl
        self.memory_space = memory_space
        self.stats = FreezeStats(registry, host_syncs_fn=lambda: self._planner.host_syncs)
        self._planner = gg.CapacityPlanner()  # fresh array: bound 0, no sync

    @classmethod
    def from_ggarray(
        cls,
        arr: gg.GGArray,
        *,
        flatten_impl: str = "segmented",
        memory_space: str | None = None,
    ):
        """Adopt an existing GGArray (no throwaway default allocation)."""
        if flatten_impl not in FLATTEN_IMPLS:
            raise ValueError(f"flatten_impl {flatten_impl!r} not in {FLATTEN_IMPLS}")
        common.check_memory_space(memory_space)
        pipe = cls.__new__(cls)
        pipe._gg = arr
        pipe._arena = None
        pipe._frozen = None
        pipe._phase = Phase.GROW
        pipe.flatten_impl = flatten_impl
        pipe.memory_space = memory_space
        pipe.stats = FreezeStats(host_syncs_fn=lambda: pipe._planner.host_syncs)
        pipe._planner = gg.CapacityPlanner.for_array(arr)  # one seed read
        return pipe

    @classmethod
    def from_arena(cls, arena):
        """Run the two-phase lifecycle over arena-backed storage.

        ``arena`` is a :class:`repro_torch.pool.SlabArena` whose ``narrays``
        play the role of blocks: append claims shared-pool slabs instead of
        growing owned buckets, and freeze() flattens through the page tables
        (paged gather + the same segmented global ordering).  The phase
        discipline, the ``FrozenArray`` view and the stats are the same, so
        consumers (``data/packing.py``'s Packer) switch backends without code
        changes; extent arenas (``grow_chunk="doubling"``/``"tz"``) included,
        where ``stats.grow_events`` counts zero-copy extent appends.
        """
        pipe = cls.__new__(cls)
        pipe._gg = None
        pipe._arena = arena
        pipe._frozen = None
        pipe._phase = Phase.GROW
        pipe.flatten_impl = "segmented"
        pipe.memory_space = arena.memory_space  # the arena owns the choice
        # share the arena's registry: pool.* and runtime.* metrics land in
        # one snapshot; the arena's planner backs host_syncs
        pipe.stats = FreezeStats(arena.registry, host_syncs_fn=lambda: arena.host_syncs)
        pipe._planner = None  # the arena's TenantPlanner owns the bounds
        return pipe

    # ---- introspection ---------------------------------------------------
    @property
    def phase(self) -> Phase:
        return self._phase

    @property
    def array(self) -> gg.GGArray:
        """The underlying GGArray (valid in either phase; grows only in GROW)."""
        if self._gg is None:
            raise PhaseError("arena-backed pipeline: use .arena, not .array")
        return self._gg

    @property
    def arena(self):
        if self._arena is None:
            raise PhaseError("ggarray-backed pipeline: use .array, not .arena")
        return self._arena

    @property
    def _store(self):
        return self._arena if self._arena is not None else self._gg

    @property
    def nblocks(self) -> int:
        return self._store.nblocks

    @property
    def sizes(self) -> torch.Tensor:
        return self._store.sizes

    def total_size(self) -> int:
        return int(self._store.sizes.sum().item())

    def memory_elems(self) -> int:
        if self._arena is not None:
            return self._arena.memory_elems()
        return gg.memory_elems(self._gg)

    def _require(self, phase: Phase, op: str) -> None:
        if self._phase is not phase:
            raise PhaseError(
                f"{op} requires phase {phase.value!r}, pipeline is "
                f"{self._phase.value!r} (freeze()/thaw() switch phases)"
            )

    # ---- GROW phase ------------------------------------------------------
    def append(self, elems: Any, mask: Any = None, *, method: str = "scan") -> torch.Tensor:
        """In-place push_back of up to ``m`` elements per block — sync-free.

        ``elems: (nblocks, m, *item_shape)`` → assigned in-block positions
        ``(nblocks, m)`` (−1 where masked out).  In the steady state the call
        reads nothing from the device; only when a growth might be needed
        does the planner read one scalar.  A ``mask`` passed as a numpy
        array lets the planner advance per-block bounds by the actual lane
        counts.  The levels are written in place: a previously captured
        ``pipeline.array`` shares them but has stale ``sizes``.
        """
        self._require(Phase.GROW, "append")
        reg = self.stats.registry
        if self._arena is not None:
            before = self._arena.pool_grow_events
            pos = self._arena.append(elems, mask)
            reg.counter("runtime.grow_events").inc(self._arena.pool_grow_events - before)
            reg.counter("runtime.appends").inc()
            return pos
        before = self._gg.nbuckets
        self._gg = self._planner.reserve(self._gg, elems.shape[1], mask=mask)
        reg.counter("runtime.grow_events").inc(self._gg.nbuckets - before)
        self._gg, pos, headroom = gg.append(self._gg, elems, mask, method=method)
        self._planner.note_append(self._gg, headroom)
        reg.counter("runtime.appends").inc()
        return pos

    # ---- the handoff -----------------------------------------------------
    def freeze(self) -> FrozenArray:
        """Flatten into a contiguous global-order array; enter FROZEN phase."""
        self._require(Phase.GROW, "freeze")
        t0 = time.perf_counter()
        if self._arena is not None:
            flat, total, starts = self._arena.flatten()
        else:
            arr = self._gg
            starts = gg.block_starts(arr)
            if self.flatten_impl == "core" or arr.item_shape:
                flat, total = gg.flatten(arr)
            else:
                flat = flatten_ops.flatten(
                    arr.buckets, arr.sizes, arr.b0, impl=self.flatten_impl,
                    memory_space=self.memory_space,
                )
                total = torch.sum(arr.sizes, dtype=torch.int32)
        if flat.is_cuda:
            torch.cuda.synchronize(flat.device)  # wall time covers the device work
        dt = time.perf_counter() - t0
        self._frozen = FrozenArray(data=flat, size=total.to(torch.int32), block_starts=starts)
        self._phase = Phase.FROZEN
        reg = self.stats.registry
        reg.counter("runtime.freezes").inc()
        # lazy device-side accumulation: the scalar stays on the device until
        # the counter is read (one transfer for every pending freeze)
        reg.counter("runtime.elements_frozen").add_lazy(total)
        reg.gauge("runtime.last_freeze_s").set(dt)
        reg.counter("runtime.freeze_s").inc(dt)
        reg.histogram("runtime.freeze_ms", "freeze() wall-clock").observe(dt * 1e3)
        return self._frozen

    def thaw(self, *, rebalance: bool = False) -> gg.GGArray:
        """Re-enter GROW. Zero-copy by default (the bucket chain is intact);
        ``rebalance=True`` redistributes the frozen contents evenly instead."""
        self._require(Phase.FROZEN, "thaw")
        t0 = time.perf_counter()
        if rebalance and self._arena is not None:
            raise PhaseError(
                "arena-backed pipelines cannot rebalance on thaw: slabs are "
                "shared-pool pages, not redistributable owned buffers"
            )
        if rebalance:
            frozen = self._frozen
            assert frozen is not None
            n = int(frozen.size.item())
            self._gg = gg.from_flat(frozen.data, n, self._gg.nblocks, self._gg.b0)
            # redistribution gives exact per-block sizes — reseed the bound
            # without a device read, carrying the lifetime sync count over
            planner = gg.CapacityPlanner(-(-n // self._gg.nblocks))
            planner.host_syncs = self._planner.host_syncs
            self._planner = planner
        self._frozen = None
        self._phase = Phase.GROW
        reg = self.stats.registry
        reg.counter("runtime.thaws").inc()
        reg.histogram("runtime.thaw_ms", "thaw() wall-clock").observe(
            (time.perf_counter() - t0) * 1e3
        )
        return self._store

    # ---- FROZEN phase ----------------------------------------------------
    @property
    def frozen(self) -> FrozenArray:
        if self._phase is not Phase.FROZEN or self._frozen is None:
            raise PhaseError("no frozen view: call freeze() first")
        return self._frozen

    def read(self, idx: Any) -> torch.Tensor:
        """Static-phase read: direct contiguous gather."""
        return self.frozen.read(idx)

    def map_frozen(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> FrozenArray:
        """Run a static work function over the contiguous buffer (live slots).

        Dead (beyond-``size``) slots are left untouched so repeated maps stay
        zero there; ``fn`` must be shape-preserving.
        """
        frozen = self.frozen
        out = fn(frozen.data)
        if out.shape != frozen.data.shape:
            raise ValueError(f"map_frozen fn changed shape: {tuple(out.shape)}")
        cond = frozen.live_mask().reshape((-1,) + (1,) * len(frozen.item_shape))
        self._frozen = dataclasses.replace(frozen, data=torch.where(cond, out, frozen.data))
        return self._frozen
