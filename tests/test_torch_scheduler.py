"""Port of the admission scheduler (``repro.serving.scheduler``): the same
arrivals, grow decisions and completions, fed to the reference and to the
port, give the same admissions, the same chunk plans, the same allocator
and page-book state and the same queue metrics — exactly."""
import dataclasses

import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:
    from _hypothesis_fallback import given, settings, st

from repro.pool import PageBook as RPageBook
from repro.pool import QuotaExceeded as RQuotaExceeded
from repro.serving import scheduler as rsched
from repro_torch.pool import PageBook, QuotaExceeded
from repro_torch.serving import scheduler as sched


@pytest.mark.parametrize("b0,chunk", [(4, 32), (8, 8), (3, 20), (64, 32), (1, 1), (2048, 1024)])
def test_buckets_match_reference(b0, chunk):
    assert sched.bucket_widths(b0, chunk) == rsched.bucket_widths(b0, chunk)
    widths = sched.bucket_widths(b0, chunk)
    for n in range(1, chunk + 1):
        assert sched.bucket_for(n, widths) == rsched.bucket_for(n, widths)
    with pytest.raises(ValueError):
        sched.bucket_for(chunk + 1, widths)


def _state(s, book):
    return {
        "phase": list(s.phase), "rid_of_slot": list(s.rid_of_slot), "t0": s.t0.tolist(),
        "length": s.length.tolist(), "prefilling": s.prefilling, "tick": s.tick,
        "pending": [(w.rid, w.length, w.skips) for w in s.pending],
        "npages": book.npages.tolist(), "pages_of": [list(p) for p in book.pages_of],
        "free": np.asarray(book.alloc.free).tolist(), "refcount": np.asarray(book.alloc.refcount).tolist(),
        "reserved": book.reserved_total, "n_slabs": book.alloc.n_slabs,
        "metrics": {k: v for k, v in s.obs.snapshot().items() if k.startswith("sched.")},
    }


def _simulate(S, Book, lengths, seed, slots, T, chunk, max_chunks, grow_cap, exact_tail, quota):
    """Drive one scheduler like an engine: admit with a capped grow hook,
    run the planned chunks (claiming from reservations), complete the
    oldest decoding slot now and then, and a decode-growth adversary claims
    unreserved slabs.  → the trace of every decision and state."""
    rng = np.random.default_rng(seed)
    book = Book(slots, quota_slabs=quota)
    s = S.Scheduler(book, slab_tokens=T, chunk=chunk, max_chunks_per_step=max_chunks,
                    exact_tail=exact_tail)
    budget = {"left": grow_cap}

    def ensure(short):
        if short > budget["left"]:
            return False
        budget["left"] -= short
        book.grow(short)
        return True

    trace = []
    queue = list(enumerate(lengths))
    for step in range(200):
        while queue and rng.random() < 0.6:
            rid, n = queue.pop(0)
            s.submit(rid, n)
        try:
            admits = s.admit(ensure)
        except Exception as e:  # the quota breach, as a value
            trace.append(("raise", type(e).__name__))
            break
        tasks = s.next_chunks()
        trace.append(("admit", admits, [dataclasses.astuple(t) for t in tasks]))
        for t in tasks:
            if t.new_slabs:
                book.claim(t.slot, t.new_slabs, from_reservation=True)
            s.chunk_done(t)
        dec = s.decoding
        if dec and rng.random() < 0.5:  # decode growth outside reservations
            slot = dec[int(rng.integers(len(dec)))]
            if book.shortfall(1) == 0:
                book.claim(slot, 1)
        if dec and rng.random() < 0.4:
            slot = dec[0]
            book.release(slot)
            s.complete(slot)
        trace.append(("state", _state(s, book)))
        if not queue and not s.busy:
            break
    return trace


@settings(max_examples=25, deadline=None)
@given(
    lengths=st.lists(st.integers(1, 40), min_size=1, max_size=12),
    seed=st.integers(0, 2**16),
    slots=st.integers(1, 4),
    T=st.integers(1, 8),
    chunk=st.sampled_from([4, 8, 16]),
    max_chunks=st.sampled_from([None, 1, 2]),
    grow_cap=st.integers(0, 40),
    exact_tail=st.booleans(),
)
def test_same_arrivals_give_the_same_decisions(lengths, seed, slots, T, chunk, max_chunks, grow_cap,
                                              exact_tail):
    args = (lengths, seed, slots, T, chunk, max_chunks, grow_cap, exact_tail, None)
    assert _simulate(sched, PageBook, *args) == _simulate(rsched, RPageBook, *args)


@pytest.mark.parametrize("seed", range(6))
def test_same_arrivals_seeded(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 60, 10).tolist()
    args = (lengths, seed, 3, 4, 8, None if seed % 2 else 1, 25, seed % 3 == 0, None)
    assert _simulate(sched, PageBook, *args) == _simulate(rsched, RPageBook, *args)


def test_quota_breach_raises_like_the_reference():
    args = ([3, 30, 2], 0, 2, 4, 8, None, 100, False, 2)
    ours, theirs = _simulate(sched, PageBook, *args), _simulate(rsched, RPageBook, *args)
    assert ours == theirs
    assert ours[-1] == ("raise", "QuotaExceeded")
    assert QuotaExceeded.__name__ == RQuotaExceeded.__name__
