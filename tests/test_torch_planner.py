"""Port of the host-side slab accounting (``repro.pool.planner``), held
against the JAX package's: the same operation sequences through both
``SlabAllocator``s, ``PageBook``s and ``TenantPlanner``s leave bitwise equal
state (free list, owners, refcounts, reservation ledger, counters, page
lists) and raise the same errors.  Host numpy code throughout: no tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:
    from _hypothesis_fallback import given, settings, st

from repro.pool import planner as ref
from repro_torch.pool import planner as port


def _alloc_state(a):
    return (a.free.tolist(), a.owner.tolist(), a.refcount.tolist(), dict(a.reserved),
            a.claims, a.reuse_claims, a.releases, a.alias_claims, a.grown_slabs, a.peak_live,
            a._ever_released.tolist(), a.free_count, a.live_count, a.reserved_total)


def _book_state(b):
    return (_alloc_state(b.alloc), b.npages.tolist(), b.page_of_slab.tolist(), b.max_pages,
            [list(p) for p in b.pages_of])


def _both(fn):
    """Run ``fn`` on the reference and the port → (result or exception type) each."""
    out = []
    for mod in (ref, port):
        try:
            out.append(fn(mod))
        except Exception as e:  # the same operation must fail the same way
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("grow_chunk", [1, 3, "geometric"])
@pytest.mark.parametrize("n_slabs,short,reserved", [(0, 1, 0), (4, 1, 0), (4, 9, 2), (7, 2, 5)])
def test_growth_amount_matches(grow_chunk, n_slabs, short, reserved):
    assert port.growth_amount(n_slabs, short, grow_chunk, reserved=reserved) == \
        ref.growth_amount(n_slabs, short, grow_chunk, reserved=reserved)


def _apply_alloc_ops(mod, ops, quota):
    a = mod.SlabAllocator(2, quota_slabs=quota)
    trace = []
    for op, tenant, k in ops:
        try:
            if op == "claim":
                short = a.shortfall(k, tenant=tenant)
                if short:
                    a.grow(short)
                trace.append(a.claim(tenant, k, from_reservation=bool(k % 2)).tolist())
            elif op == "reserve":
                short = a.shortfall(k)
                if short:
                    a.grow(short)
                a.reserve(tenant, k)
            elif op == "unreserve":
                trace.append(a.unreserve(tenant, k or None))
            elif op == "addref":
                held = np.flatnonzero(a.owner == tenant)[:k]
                a.addref(held)
            elif op == "release":
                held = np.flatnonzero(~a.free)[: k + 1]
                trace.append(a.release(held, tenant=tenant).tolist())
            elif op == "release_tenant":
                trace.append(a.release_tenant(tenant).tolist())
            a.check()
        except (RuntimeError, AssertionError) as e:
            trace.append(type(e).__name__)
        trace.append(_alloc_state(a))
    return trace


_ALLOC_OPS = st.lists(
    st.tuples(st.sampled_from(["claim", "reserve", "unreserve", "addref", "release",
                               "release_tenant"]),
              st.integers(0, 3), st.integers(0, 4)),
    min_size=1, max_size=25,
)


@given(_ALLOC_OPS, st.sampled_from([None, 3, 6]))
@settings(max_examples=60, deadline=None)
def test_allocator_state_matches_under_random_ops(ops, quota):
    assert _apply_alloc_ops(port, ops, quota) == _apply_alloc_ops(ref, ops, quota)


@pytest.mark.parametrize("seed", range(4))
def test_allocator_state_matches_seeded(seed):
    """The same comparison on fixed seeded sequences (runs without hypothesis)."""
    rng = np.random.default_rng(seed)
    names = ["claim", "reserve", "unreserve", "addref", "release", "release_tenant"]
    ops = [(names[int(rng.integers(0, 6))], int(rng.integers(0, 4)), int(rng.integers(0, 5)))
           for _ in range(30)]
    for quota in (None, 4):
        assert _apply_alloc_ops(port, ops, quota) == _apply_alloc_ops(ref, ops, quota)


def test_allocator_errors_match():
    def double_free(mod):
        a = mod.SlabAllocator(4)
        ids = a.claim(0, 2)
        a.release(ids)
        a.release(ids)

    def alias_free(mod):
        mod.SlabAllocator(4).addref(np.asarray([1]))

    def exhausted(mod):
        mod.SlabAllocator(2).claim(0, 3)

    def over_quota(mod):
        a = mod.SlabAllocator(8, quota_slabs=2)
        a.claim(1, 2)
        a.claim(1, 1)

    for fn in (double_free, alias_free, exhausted, over_quota):
        r, p = _both(fn)
        assert r == p and isinstance(r, str), fn.__name__
    assert issubclass(port.QuotaExceeded, RuntimeError)


def _apply_book_ops(mod, ops):
    b = mod.PageBook(3, quota_slabs=None)
    trace = []
    for op, tenant, k in ops:
        if op == "claim":
            short = b.shortfall(k)
            if short:
                b.grow(short)
            widened = b.widen(int(b.npages[tenant]) + k)
            ids, page0 = b.claim(tenant, k)
            trace.append((widened, ids.tolist(), page0))
        elif op == "alias":
            src = b.pages_in_order((tenant + 1) % 3)[:k]
            trace.append(b.alias(tenant, src))
        elif op == "adopt":
            src = b.pages_in_order((tenant + 2) % 3)[:k]
            b.alloc.addref(src)
            trace.append(b.adopt(tenant, src))
        elif op == "replace":
            if b.npages[tenant] > 0:
                if b.shortfall(1):
                    b.grow(1)
                new = b.alloc.claim(tenant, 1)
                old = b.replace(tenant, k % int(b.npages[tenant]), int(new[0]))
                trace.append(b.alloc.release(np.asarray([old]), tenant=tenant).tolist())
        elif op == "release":
            trace.append(b.release(tenant).tolist())
        elif op == "reserve":
            if b.shortfall(k):
                b.grow(b.shortfall(k))
            b.reserve(tenant, k)
            trace.append(b.reserved_total)
        b.alloc.check()
        trace.append(_book_state(b))
        trace.append([b.pages_in_order(t).tolist() for t in range(3)])
    return trace


@given(st.lists(st.tuples(st.sampled_from(["claim", "alias", "adopt", "replace", "release",
                                           "reserve"]),
                          st.integers(0, 2), st.integers(0, 3)),
                min_size=1, max_size=25))
@settings(max_examples=60, deadline=None)
def test_pagebook_state_matches_under_random_ops(ops):
    assert _apply_book_ops(port, ops) == _apply_book_ops(ref, ops)


@pytest.mark.parametrize("seed", range(4))
def test_pagebook_state_matches_seeded(seed):
    rng = np.random.default_rng(100 + seed)
    names = ["claim", "alias", "adopt", "replace", "release", "reserve"]
    ops = [(names[int(rng.integers(0, 6))], int(rng.integers(0, 3)), int(rng.integers(0, 4)))
           for _ in range(40)]
    assert _apply_book_ops(port, ops) == _apply_book_ops(ref, ops)


@pytest.mark.parametrize("kind", ["none", "numpy", "list", "bad_shape", "device"])
def test_tenant_planner_plan_matches(kind):
    rng = np.random.default_rng(5)
    mask = rng.random((4, 6)) < 0.5
    masks = {
        "none": (None, None),
        "numpy": (mask, mask),
        "list": (mask.tolist(), mask.tolist()),
        "bad_shape": (mask[:3], mask[:3]),
        # a device array on one side, a tensor on the other: never host-known
        "device": (jnp.asarray(mask), torch.from_numpy(mask)),
    }
    r_mask, p_mask = masks[kind]
    rp, pp = ref.TenantPlanner(4), port.TenantPlanner(4)
    r_counts, r_exact = rp.plan(6, r_mask)
    p_counts, p_exact = pp.plan(6, p_mask)
    np.testing.assert_array_equal(p_counts, r_counts)
    assert p_exact == r_exact
    rp.advance(r_counts)
    pp.advance(p_counts)
    rp.reset(2)
    pp.reset(2)
    np.testing.assert_array_equal(pp.ub, rp.ub)


def test_tenant_planner_sync_is_one_counted_read():
    sizes = np.asarray([3, 0, 9, 4], np.int32)
    rp, pp = ref.TenantPlanner(4), port.TenantPlanner(4)
    np.testing.assert_array_equal(pp.sync(torch.from_numpy(sizes)), rp.sync(jnp.asarray(sizes)))
    assert pp.host_syncs == rp.host_syncs == 1
    assert pp.ub.dtype == rp.ub.dtype == np.int64
