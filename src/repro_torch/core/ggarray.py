"""GGArray — a dynamically growable array (paper §IV), port of ``repro.core.ggarray``.

Structure: ``nblocks`` LFVectors, each a chain of geometric buckets (bucket
``b`` holds ``B0 * 2**b`` items).  Growth appends a bucket level **without
copying** any existing element.  ``push_back`` runs on the device with no
cross-block communication: one CUDA thread block per GGArray block (K3).

The container holds one tensor per bucket level, shaped ``(nblocks, B0*2**b,
*item)``, plus ``sizes: (nblocks,)`` int32.

**In place, not donated.**  The reference donates its input to ``append``
(``donate_argnums``) so XLA writes into the old buffers.  Here
:func:`append` writes the scattered elements into the array's level tensors
in place and returns the array with its new ``sizes``; :func:`push_back`
clones the levels first and leaves its input untouched.

**Host syncs.**  The append path reads nothing from the device.
:class:`CapacityPlanner` reads one scalar (or one size vector) only when a
growth might be needed, in the same places as the reference, and counts each
read in ``host_syncs``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import indexing
from repro_torch.core.insertion import insertion_offsets
from repro_torch.kernels.common import put_drop_, scatter_levels_

__all__ = [
    "GGArray",
    "init",
    "push_back",
    "append",
    "grow",
    "needs_grow",
    "ensure_capacity",
    "reserve",
    "CapacityPlanner",
    "PUSH_BACK_METHODS",
    "flatten",
    "from_flat",
    "read_global",
    "write_global",
    "gather_block",
    "map_elements",
    "total_size",
    "memory_elems",
    "block_starts",
]


@dataclasses.dataclass(frozen=True)
class GGArray:
    """Array of LFVectors (Fig. 2 of the paper)."""

    buckets: tuple[torch.Tensor, ...]  # level b: (nblocks, B0*2**b, *item_shape)
    sizes: torch.Tensor  # (nblocks,) int32 — per-LFVector element count
    b0: int = 8

    @property
    def nblocks(self) -> int:
        return self.buckets[0].shape[0]

    @property
    def nbuckets(self) -> int:
        return len(self.buckets)

    @property
    def item_shape(self) -> tuple[int, ...]:
        return tuple(self.buckets[0].shape[2:])

    @property
    def dtype(self) -> torch.dtype:
        return self.buckets[0].dtype

    @property
    def device(self) -> torch.device:
        return self.sizes.device

    @property
    def capacity_per_block(self) -> int:
        return indexing.capacity(self.b0, self.nbuckets)

    @property
    def capacity(self) -> int:
        return self.nblocks * self.capacity_per_block


def init(
    nblocks: int,
    b0: int = 8,
    item_shape: Sequence[int] = (),
    dtype: torch.dtype = torch.float32,
    nbuckets: int = 1,
    *,
    device: "str | torch.device | None" = None,
) -> GGArray:
    """Fresh empty GGArray with ``nbuckets`` pre-allocated levels.

    ``device=None`` means the CUDA card (raises without one); pass
    ``device="cpu"`` to run on the CPU.
    """
    if nbuckets < 1:
        raise ValueError("need at least one bucket level")
    dev = _device.resolve(device)
    buckets = tuple(
        torch.zeros((nblocks, sz, *item_shape), dtype=dtype, device=dev)
        for sz in indexing.bucket_sizes(b0, nbuckets)
    )
    sizes = torch.zeros((nblocks,), dtype=torch.int32, device=dev)
    return GGArray(buckets=buckets, sizes=sizes, b0=b0)


# --------------------------------------------------------------------------
# Growth (paper Alg. 2 — new_bucket). Copy-free by construction.
# --------------------------------------------------------------------------

def grow(gg: GGArray, levels: int = 1) -> GGArray:
    """Append ``levels`` new bucket levels. Never touches existing buckets."""
    new_sizes = indexing.bucket_sizes(gg.b0, gg.nbuckets + levels)[gg.nbuckets:]
    new = tuple(
        torch.zeros((gg.nblocks, sz, *gg.item_shape), dtype=gg.dtype, device=gg.device)
        for sz in new_sizes
    )
    return dataclasses.replace(gg, buckets=gg.buckets + new)


def needs_grow(gg: GGArray, n_new_per_block: "torch.Tensor | int") -> torch.Tensor:
    """True (a device bool) if any block would overflow after inserting ``n_new_per_block``."""
    return torch.any(gg.sizes + n_new_per_block > gg.capacity_per_block)


def reserve(gg: GGArray, n_new_per_block: int, *, max_size: int | None = None) -> GGArray:
    """Lookahead capacity planner: grow until ``max_size + n`` fits per block.

    ``max_size`` is a host-known upper bound on the per-block element count;
    with it this performs **zero** device reads.  ``None`` reads one device
    scalar.
    """
    if max_size is None:
        max_size = int(gg.sizes.max().item())
    nb = gg.nbuckets
    while indexing.capacity(gg.b0, nb) < max_size + n_new_per_block:
        nb += 1
    if nb > gg.nbuckets:
        gg = grow(gg, nb - gg.nbuckets)
    return gg


def ensure_capacity(gg: GGArray, n_new_per_block: int) -> GGArray:
    """Growth loop with a per-call device read (one-shot/interactive use)."""
    return reserve(gg, n_new_per_block)


class CapacityPlanner:
    """Host-side size tracking → O(log n) host contacts over a growth phase.

    Keeps a conservative upper bound on the max per-block size (each wave of
    ``m`` grows it by ``m``).  ``reserve`` compares it with the capacity:

    * bound + m ≤ capacity — the wave provably fits: no device read.
    * bound + m > capacity — read one scalar (the headroom :func:`append`
      returned, else a fresh ``max(sizes)``), reset the bound to the true
      size, and grow if the true size really overflows.

    A **host-known** mask (numpy or Python lists — never a tensor, on any
    device) advances a per-block bound vector by the actual lane counts, so
    skewed masked loads also stay at O(log n) host contacts.
    """

    def __init__(self, size_upper_bound: int = 0):
        self.size_ub = size_upper_bound
        self.host_syncs = 0  # device→host reads issued by the planner
        self.grow_events = 0
        self._headroom: tuple[torch.Tensor, int] | None = None  # (flag, cap then)
        self._ub_vec: "np.ndarray | None" = None  # per-block bound (mask path)

    @classmethod
    def for_array(cls, gg: GGArray) -> "CapacityPlanner":
        """Adopt an existing array: one scalar read to seed the bound."""
        planner = cls(int(gg.sizes.max().item()))
        planner.host_syncs += 1
        return planner

    def note_append(self, gg: GGArray, headroom: torch.Tensor) -> None:
        """Record the device-side headroom flag an append returned."""
        self._headroom = (headroom, gg.capacity_per_block)

    def observed_max(self) -> int:
        """Host-read the true max per-block size (one scalar transfer)."""
        assert self._headroom is not None
        flag, cap_then = self._headroom
        self.host_syncs += 1
        return cap_then - int(flag.item())

    def metrics(self) -> dict:
        """Host-contact accounting as plain data."""
        return {
            "planner.host_syncs": self.host_syncs,
            "planner.grow_events": self.grow_events,
            "planner.size_ub": self.size_ub,
        }

    @staticmethod
    def _host_lane_counts(mask: Any, nblocks: int) -> "np.ndarray | None":
        """Per-block enabled-lane counts iff ``mask`` is host-known.

        Tensors return None, whatever their device — reading one would be the
        transfer the planner exists to avoid (and keeps the counts equal to
        the reference's, where a ``jax.Array`` is never host-known).
        """
        if mask is None or isinstance(mask, torch.Tensor):
            return None
        arr = np.asarray(mask)
        if arr.ndim != 2 or arr.shape[0] != nblocks:
            return None
        return (arr != 0).sum(axis=1).astype(np.int64)

    def reserve(self, gg: GGArray, n_new_per_block: int, *, mask: Any = None) -> GGArray:
        cap = gg.capacity_per_block
        counts = self._host_lane_counts(mask, gg.nblocks)
        if counts is not None:
            if self._ub_vec is None or len(self._ub_vec) != gg.nblocks:
                self._ub_vec = np.full((gg.nblocks,), self.size_ub, np.int64)
            if int((self._ub_vec + counts).max()) <= cap:
                self._ub_vec += counts  # skew-exact steady state: no contact
                self.size_ub = int(self._ub_vec.max())
                return gg
        elif self.size_ub + n_new_per_block <= cap:
            self.size_ub += n_new_per_block  # steady state: zero host contact
            if self._ub_vec is not None:
                self._ub_vec += n_new_per_block  # device mask: pessimistic
            return gg
        if counts is not None:
            # one vector transfer re-seeds the per-block bounds exactly
            sizes = gg.sizes.cpu().numpy().astype(np.int64)
            self.host_syncs += 1
            self._headroom = None
            self._ub_vec = sizes + counts
            self.size_ub = int(self._ub_vec.max())
            before = gg.nbuckets
            gg = reserve(gg, 0, max_size=self.size_ub)
            self.grow_events += gg.nbuckets - before
            return gg
        if self._headroom is not None:
            true_max = self.observed_max()
        else:
            true_max = int(gg.sizes.max().item())
            self.host_syncs += 1
        self.size_ub = true_max + n_new_per_block
        self._ub_vec = None  # scalar re-seed invalidates the vector bound
        before = gg.nbuckets
        gg = reserve(gg, n_new_per_block, max_size=true_max)
        self.grow_events += gg.nbuckets - before
        return gg


# --------------------------------------------------------------------------
# push_back (paper Alg. 1) — block-local, zero collectives.
# --------------------------------------------------------------------------

# push_back's insertion backends: the offsets-only algorithms from
# core.insertion, "fused" (kernel K3: offsets and the scatter into every
# level in one launch), and "auto" — fused at or above
# kernels/tuning.FUSED_PUSH_BACK_MIN_WAVE lanes, scan below it.
PUSH_BACK_METHODS = ("atomic", "auto", "fused", "mxu", "scan", "tile")


def _as_device(x: Any, dev: torch.device) -> torch.Tensor:
    """A tensor on ``dev``: numpy / lists are copied over, tensors already
    there are used as they are."""
    return torch.as_tensor(x, device=dev)


def _push_back_(
    gg: GGArray,
    elems: Any,
    mask: Any,
    method: str,
) -> tuple[GGArray, torch.Tensor]:
    """Shared body of ``push_back`` / ``append``: writes ``gg``'s levels in place."""
    elems = _as_device(elems, gg.device)
    if elems.ndim < 2 or elems.shape[0] != gg.nblocks:
        raise ValueError(
            f"elems must be (nblocks={gg.nblocks}, m, ...), got {tuple(elems.shape)}"
        )
    if method == "auto":
        from repro_torch.kernels.tuning import resolve_push_back_method

        method = resolve_push_back_method(method, elems.shape[1])
    if mask is None:
        mask = torch.ones(elems.shape[:2], dtype=torch.bool, device=gg.device)
    mask = _as_device(mask, gg.device)
    if mask.dtype.is_floating_point or mask.dtype.is_complex:
        raise TypeError(f"mask must be bool or integer, got {mask.dtype}")
    if mask.dtype != torch.bool:
        mask = mask != 0  # count lanes, not values (insertion_offsets contract)
    elems = elems.to(gg.dtype)
    if method == "fused" and elems.shape[1] > 0:
        from repro_torch.kernels.push_back import ops as push_back_ops

        _, sizes, pos = push_back_ops.push_back_fused(
            gg.buckets, gg.sizes, gg.b0, elems, mask
        )
        return dataclasses.replace(gg, sizes=sizes), pos
    if method == "fused":  # empty waves: plain path
        method = "scan"
    offsets, counts = insertion_offsets(mask, method=method)
    pos = gg.sizes[:, None] + offsets
    scatter_levels_(gg.buckets, gg.b0, pos, mask, elems)
    new = dataclasses.replace(gg, sizes=gg.sizes + counts)
    return new, torch.where(mask, pos, -1)


def push_back(
    gg: GGArray,
    elems: Any,
    mask: Any = None,
    method: str = "auto",
) -> tuple[GGArray, torch.Tensor]:
    """Parallel push_back of up to ``m`` elements per block (paper Alg. 1).

    ``elems: (nblocks, m, *item_shape)``; ``mask: (nblocks, m)`` selects which
    lanes insert (all, if None).  Returns the updated array and the assigned
    in-block positions ``(nblocks, m)`` (−1 where masked out).  Capacity must
    already suffice (``reserve``/``ensure_capacity``); writes past it are
    dropped.

    Works on clones of the levels: ``gg`` stays valid and unchanged.  Hot
    loops should use :func:`append`, which writes in place.
    """
    clone = dataclasses.replace(gg, buckets=tuple(b.clone() for b in gg.buckets))
    return _push_back_(clone, elems, mask, method)


def append(
    gg: GGArray,
    elems: Any,
    mask: Any = None,
    method: str = "auto",
) -> tuple[GGArray, torch.Tensor, torch.Tensor]:
    """In-place push_back — the host-sync-free hot path.

    Same semantics as :func:`push_back` plus:

    * ``gg``'s level tensors are **written in place** (the reference donates
      them); the returned array shares them and carries the new ``sizes``.
      Rebind to the returned array: the old one's ``sizes`` are stale.
    * returns a third value ``headroom``, a device-side int32 scalar
      ``capacity_per_block − max(new sizes)``.  Negative means the wave
      overflowed capacity and writes were dropped.  The host never reads it
      in the steady state; :class:`CapacityPlanner` reads it only when a
      growth might be needed.
    """
    new, pos = _push_back_(gg, elems, mask, method)
    headroom = new.capacity_per_block - torch.max(new.sizes)
    return new, pos, headroom.to(torch.int32)


# --------------------------------------------------------------------------
# Element access — rw_g (global, binary search) and rw_b (per-block).
# --------------------------------------------------------------------------

def block_starts(gg: GGArray) -> torch.Tensor:
    """The paper's global prefix-sum index table."""
    return indexing.block_starts(gg.sizes)


def _gather_inblock(gg: GGArray, block: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Gather elements at per-block positions — walks the bucket chain."""
    starts = indexing.bucket_starts(gg.b0, gg.nbuckets)
    sizes = indexing.bucket_sizes(gg.b0, gg.nbuckets)
    block = block.long()
    out = torch.zeros((*pos.shape, *gg.item_shape), dtype=gg.dtype, device=gg.device)
    for b in range(gg.nbuckets):
        li = (pos - starts[b]).clamp(0, sizes[b] - 1).long()
        in_level = (pos >= starts[b]) & (pos < starts[b] + sizes[b])
        vals = gg.buckets[b][block, li]
        cond = in_level.reshape(in_level.shape + (1,) * len(gg.item_shape))
        out = torch.where(cond, vals, out)
    return out


def read_global(gg: GGArray, idx: Any) -> torch.Tensor:
    """rw_g: read by global index (block-major order) via binary search."""
    idx = _as_device(idx, gg.device)
    starts = block_starts(gg)
    block = indexing.find_block(starts, idx).long()
    return _gather_inblock(gg, block, idx - starts[block])


def write_global(gg: GGArray, idx: Any, vals: Any) -> GGArray:
    """rw_g write: scatter by global index via binary search.

    Returns a new array; ``gg``'s levels are left untouched.
    """
    idx = _as_device(idx, gg.device)
    vals = _as_device(vals, gg.device).to(gg.dtype)
    starts = block_starts(gg)
    block = indexing.find_block(starts, idx).long()
    pos = idx - starts[block]
    bstarts = indexing.bucket_starts(gg.b0, gg.nbuckets)
    bsizes = indexing.bucket_sizes(gg.b0, gg.nbuckets)
    buckets = []
    for b in range(gg.nbuckets):
        li = pos - bstarts[b]
        in_level = (li >= 0) & (li < bsizes[b])
        buckets.append(put_drop_(gg.buckets[b].clone(), (block, li), in_level, vals))
    return dataclasses.replace(gg, buckets=tuple(buckets))


def gather_block(gg: GGArray, block: Any, pos: Any) -> torch.Tensor:
    """rw_b read: caller already knows the owning block (no search)."""
    return _gather_inblock(gg, _as_device(block, gg.device), _as_device(pos, gg.device))


def map_elements(gg: GGArray, fn: Callable[[torch.Tensor], torch.Tensor]) -> GGArray:
    """rw_b: apply ``fn`` to every *live* element, bucket-parallel (new levels)."""
    starts = indexing.bucket_starts(gg.b0, gg.nbuckets)
    sizes = indexing.bucket_sizes(gg.b0, gg.nbuckets)
    buckets = []
    for b in range(gg.nbuckets):
        posn = starts[b] + torch.arange(sizes[b], dtype=torch.int32, device=gg.device)[None, :]
        live = posn < gg.sizes[:, None]
        live = live.reshape(live.shape + (1,) * len(gg.item_shape))
        buckets.append(torch.where(live, fn(gg.buckets[b]), gg.buckets[b]))
    return dataclasses.replace(gg, buckets=tuple(buckets))


# --------------------------------------------------------------------------
# Flatten — the two-phase pattern's bridge to a contiguous array (§VI.D).
# --------------------------------------------------------------------------

def flatten(gg: GGArray) -> tuple[torch.Tensor, torch.Tensor]:
    """Emit a contiguous (capacity-sized) array in block-major global order.

    Returns ``(flat, total)`` where ``flat[:total]`` are the live elements in
    global order; slots ≥ total are 0.  Plain PyTorch, any item shape.
    """
    starts = block_starts(gg)
    cap = gg.capacity
    flat = torch.zeros((cap, *gg.item_shape), dtype=gg.dtype, device=gg.device)
    bstarts = indexing.bucket_starts(gg.b0, gg.nbuckets)
    bsizes = indexing.bucket_sizes(gg.b0, gg.nbuckets)
    for b in range(gg.nbuckets):
        posn = bstarts[b] + torch.arange(bsizes[b], dtype=torch.int32, device=gg.device)[None, :]
        live = posn < gg.sizes[:, None]
        tgt = starts[:, None] + posn
        put_drop_(flat, (tgt,), live & (tgt < cap), gg.buckets[b])
    return flat, torch.sum(gg.sizes, dtype=torch.int32)


def from_flat(flat: torch.Tensor, n: int, nblocks: int, b0: int = 8) -> GGArray:
    """Distribute ``flat[:n]`` evenly into a fresh GGArray on ``flat``'s device."""
    per_block = -(-n // nblocks)  # ceil
    nbuckets = indexing.min_buckets_for(b0, per_block)
    gg = init(nblocks, b0, tuple(flat.shape[1:]), flat.dtype, nbuckets=max(nbuckets, 1),
              device=flat.device)
    src = torch.arange(nblocks * per_block, device=flat.device).reshape(nblocks, per_block)
    mask = src < n
    elems = flat[src.clamp(0, flat.shape[0] - 1)]
    gg, _, _ = append(gg, elems, mask)
    return gg


# --------------------------------------------------------------------------
# Introspection.
# --------------------------------------------------------------------------

def total_size(gg: GGArray) -> torch.Tensor:
    return torch.sum(gg.sizes, dtype=torch.int32)


def memory_elems(gg: GGArray) -> int:
    """Allocated element slots (the §V memory-usage metric)."""
    return gg.capacity
