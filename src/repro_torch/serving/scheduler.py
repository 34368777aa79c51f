"""Admission scheduler for :class:`BatchEngine` — bucketed chunked prefill
(port of ``repro/serving/scheduler.py``, host-only and nearly verbatim).

Pure host state over a :class:`repro.pool.PageBook` (no model, no device),
so the scheduling invariants are property-testable in isolation
(``tests/serving/test_scheduler.py``).  The engine drives it per step:

1. ``admit()`` — scan the FIFO queue, assigning a free decode slot and
   **reserving** the prompt's full slab need (``planner.SlabAllocator``
   reservation ledger) for every request the pool can cover.  Reserving up
   front is the §7 invariant: decode-growth claims see
   ``free − reserved`` availability, so a decode burst can never strand an
   admitted prefill halfway through its chunks.
2. ``next_chunks()`` — one :class:`ChunkTask` per prefilling slot (oldest
   admission first): the next ``chunk``-sized window of the prompt, padded
   to a **geometric length bucket**, plus the slab claim that covers it.
3. ``chunk_done()`` — advance the slot; the final chunk flips it to the
   decode phase.

Bucketed padding bounds the distinct chunk shapes: every chunk is one of
``bucket_widths(b0, chunk)`` widths (``b0·2^i`` up to ``chunk``), so a fleet
of arbitrary prompt lengths runs **O(log chunk)** distinct prefill widths
(the reference compiles one trace per width; PyTorch runs eagerly, and the
widths are kept so both packages plan the same chunks).  ``exact_tail=True`` (hybrid SSM layouts) opts
the *final* chunk out of padding: pad tokens are exactly dead lanes for
attention (DESIGN.md §7 bit-exactness contract) but would pollute the Mamba
conv/SSD recurrence (``dt = softplus(dt_bias) ≠ 0`` on pad rows).

Admission order is FIFO with bounded skip-ahead: a request whose slab need
cannot be covered is skipped (smaller later requests may still admit — the
"admit whenever slots AND slabs allow" policy), but once the oldest waiter
has been skipped ``starvation_limit`` times it head-of-line blocks the queue
until it fits.  Two requests with equal slab need therefore always admit in
submission order (FIFO-within-bucket), and no request waits forever.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.obs import ServingTimeline
from repro_torch.pool import PageBook, QuotaExceeded

__all__ = ["Scheduler", "ChunkTask", "bucket_widths", "bucket_for"]


def bucket_widths(b0: int, chunk: int) -> tuple[int, ...]:
    """Geometric chunk-width buckets ``b0·2^i`` capped at ``chunk``."""
    if b0 <= 0 or chunk <= 0:
        raise ValueError(f"need positive b0/chunk, got {b0}/{chunk}")
    out = []
    w = min(b0, chunk)
    while w < chunk:
        out.append(w)
        w *= 2
    out.append(chunk)
    return tuple(out)


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket ≥ n (buckets ascending; n ≤ buckets[-1])."""
    for w in buckets:
        if w >= n:
            return w
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass
class ChunkTask:
    """One prefill chunk for the engine to execute."""

    rid: int
    slot: int
    t0: int  # prompt tokens already prefilled
    live: int  # live tokens in this chunk
    width: int  # padded (bucketed) chunk width ≥ live
    new_slabs: int  # slabs to claim-from-reservation before running it
    final: bool  # last chunk → slot flips to decode


@dataclasses.dataclass
class _Waiting:
    rid: int
    length: int
    skips: int = 0
    submit_tick: int = 0  # scheduler tick (admit() round) at submission


class Scheduler:
    """Host-only admission + chunk planning over a shared ``PageBook``."""

    def __init__(
        self,
        book: PageBook,
        *,
        slab_tokens: int,
        chunk: int,
        buckets: tuple[int, ...] | None = None,
        exact_tail: bool = False,
        max_chunks_per_step: int | None = None,
        starvation_limit: int = 4,
        obs: ServingTimeline | None = None,
    ):
        self.book = book
        self.obs = obs if obs is not None else ServingTimeline()
        self.T = slab_tokens
        self.C = chunk
        self.buckets = (
            bucket_widths(min(slab_tokens, chunk), chunk)
            if buckets is None
            else tuple(buckets)
        )
        if self.buckets[-1] != chunk:
            raise ValueError(f"buckets {self.buckets} must end at chunk={chunk}")
        self.exact_tail = exact_tail
        self.starvation_limit = starvation_limit
        B = len(book.npages)
        self.B = B
        self.max_chunks = B if max_chunks_per_step is None else max_chunks_per_step
        self.rid_of_slot: list[int | None] = [None] * B
        self.phase = ["idle"] * B  # idle | prefill | decode
        self.t0 = np.zeros((B,), np.int64)
        self.length = np.zeros((B,), np.int64)
        self.pending: collections.deque[_Waiting] = collections.deque()
        self._prefillq: collections.deque[int] = collections.deque()
        self.tick = 0  # completed admit() rounds — the queue-wait clock

    # ---- queries ---------------------------------------------------------
    @property
    def busy(self) -> bool:
        return bool(self.pending) or any(p != "idle" for p in self.phase)

    @property
    def prefilling(self) -> list[int]:
        return list(self._prefillq)

    @property
    def decoding(self) -> list[int]:
        return [s for s in range(self.B) if self.phase[s] == "decode"]

    def slabs_for(self, length: int) -> int:
        """Total slabs a prompt of ``length`` occupies (≥ 1)."""
        return max(math.ceil(length / self.T), 1)

    # ---- lifecycle -------------------------------------------------------
    def submit(self, rid: int, length: int) -> None:
        self.pending.append(_Waiting(rid, length, submit_tick=self.tick))

    def admit(
        self,
        ensure: Callable[[int], bool] | None = None,
        match: Callable[[int, int], int] | None = None,
    ) -> list[tuple[int, int, int]]:
        """Admit what fits → [(rid, slot, reserved_slabs)].

        ``ensure(short)`` asks the caller to grow the pool by ``short``
        slabs; returning False leaves the request waiting.  FIFO scan with
        skip-ahead; the oldest waiter head-of-line blocks after
        ``starvation_limit`` skips.  Raises :class:`QuotaExceeded` when a
        request's whole-prompt need breaches its slot quota (it can never
        admit, so waiting would deadlock the queue).

        ``match(rid, length)`` is the prefix-cache hook (DESIGN.md §10): it
        returns the request's cached-prefix length in tokens (slab-aligned,
        0 = cold).  The whole-prompt reservation shrinks to the **uncached
        suffix** and prefill starts at the first uncached token
        (``t0[slot]`` = cached length); the caller aliases the cached slabs
        into the slot's page table right after ``admit`` returns, before
        planning chunks.  A fully cached prompt admits with zero prefill
        chunks — the slot goes straight to the decode phase and the caller
        arms decode on the last prompt token.
        """
        out: list[tuple[int, int, int]] = []
        survivors: collections.deque[_Waiting] = collections.deque()
        blocked = False
        free = collections.deque(
            s for s in range(self.B) if self.phase[s] == "idle"
        )
        while self.pending:
            w = self.pending.popleft()
            if blocked or not free:
                survivors.append(w)
                continue
            cached = 0 if match is None else min(match(w.rid, w.length), w.length)
            need = self.slabs_for(w.length) - cached // self.T
            slot = free[0]
            short = self.book.shortfall(need)
            if short and not (ensure is not None and ensure(short)):
                w.skips += 1
                self.obs.registry.counter(
                    "sched.starvation_skips", "waiters passed over for slabs"
                ).inc()
                self.obs.event("starve_skip", rid=w.rid, skips=w.skips)
                survivors.append(w)
                if len(survivors) == 1 and w.skips >= self.starvation_limit:
                    blocked = True  # aged head: no more skip-ahead past it
                    self.obs.registry.counter(
                        "sched.head_blocks", "aged head halted skip-ahead"
                    ).inc()
                    self.obs.event("head_block", rid=w.rid)
                continue
            try:
                self.book.reserve(slot, need)
            except QuotaExceeded:
                survivors.append(w)
                survivors.extend(self.pending)
                self.pending = survivors
                raise
            free.popleft()
            self.rid_of_slot[slot] = w.rid
            self.t0[slot] = cached
            self.length[slot] = w.length
            if cached >= w.length:  # fully cached: no prefill chunks at all
                self.phase[slot] = "decode"
            else:
                self.phase[slot] = "prefill"
                self._prefillq.append(slot)
            self.obs.registry.histogram(
                "sched.queue_wait_ticks", "admit() rounds waited in queue"
            ).observe(self.tick - w.submit_tick, rid=w.rid)
            out.append((w.rid, slot, need))
        self.pending = survivors
        self.tick += 1
        return out

    def next_chunks(self) -> list[ChunkTask]:
        """Chunk tasks for this step — ≤ ``max_chunks``, oldest slot first.

        Call once per step and report each executed task via
        ``chunk_done``; tasks are *plans*, nothing is claimed yet.
        """
        out = []
        for slot in list(self._prefillq)[: self.max_chunks]:
            t0 = int(self.t0[slot])
            L = int(self.length[slot])
            live = min(self.C, L - t0)
            final = t0 + live >= L
            if final and self.exact_tail:
                width = live
            else:
                width = bucket_for(live, self.buckets)
            cover = self.slabs_for(t0 + live)
            new = max(cover - int(self.book.npages[slot]), 0)
            out.append(
                ChunkTask(
                    rid=self.rid_of_slot[slot], slot=slot, t0=t0, live=live,
                    width=width, new_slabs=new, final=final,
                )
            )
        return out

    def chunk_done(self, task: ChunkTask) -> None:
        self.t0[task.slot] += task.live
        if self.t0[task.slot] >= self.length[task.slot]:
            self.phase[task.slot] = "decode"
            self._prefillq.remove(task.slot)

    def complete(self, slot: int) -> None:
        """The slot's request finished (caller released its slabs)."""
        if self.phase[slot] == "prefill":
            self._prefillq.remove(slot)
        self.phase[slot] = "idle"
        self.rid_of_slot[slot] = None
        self.t0[slot] = 0
        self.length[slot] = 0

    def describe(self) -> dict:
        """Full host state → JSON-ready dict (flight-recorder bundles)."""
        return {
            "tick": self.tick,
            "phase": list(self.phase),
            "rid_of_slot": list(self.rid_of_slot),
            "t0": self.t0.tolist(),
            "length": self.length.tolist(),
            "prefilling": list(self._prefillq),
            "pending": [
                {
                    "rid": w.rid, "length": w.length, "skips": w.skips,
                    "submit_tick": w.submit_tick,
                }
                for w in self.pending
            ],
            "buckets": list(self.buckets),
            "chunk": self.C,
            "max_chunks_per_step": self.max_chunks,
        }
