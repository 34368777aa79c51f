"""Port of the slab arena (``repro.pool.arena``), mirroring
``tests/pool/test_arena.py`` and held against the JAX ``SlabArena`` on the
CPU: the same waves and releases leave bitwise equal state — pool extents,
free bitmap, page tables, sizes, allocator owners/refcounts/free list —
positions, logical views and flattens, in the flat and the extent layouts,
with scalar and non-scalar items, and the same host-sync counts.

The reference's property test bounds capacity by the live tokens after
releases; the pool never shrinks, so its capacity keeps the high-water mark
while live tokens fall, and that bound fails for some seeds although the
arena is right.  The port is held to the invariants the test states: every
slab is free or held by exactly one array, free slabs are reused before the
pool grows, and capacity ≤ peak live tokens + 8·narrays.  No tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:
    from _hypothesis_fallback import given, settings, st

from repro.pool import SlabArena as RefArena
from repro_torch import convert
from repro_torch.core import ggarray as gg
from repro_torch.pool import ArenaGGArray, QuotaExceeded, SlabArena
from repro_torch.pool.arena import geometric_page_groups
from repro_torch.pool import arena as arena_mod


def _bits(a: np.ndarray) -> np.ndarray:
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _ref_state(arena) -> dict:
    """The JAX arena's state under ``convert.ARENA_KEYS``, as numpy."""
    return {
        "extents": [np.asarray(e) for e in arena.pool.extents],
        "free": np.asarray(arena.pool.free),
        "pages": np.asarray(arena.arr.pages),
        "sizes": np.asarray(arena.arr.sizes),
        "owner": np.array(arena.alloc.owner),
        "refcount": np.array(arena.alloc.refcount),
        "alloc_free": np.array(arena.alloc.free),
    }


def _assert_state_same(ours, theirs):
    a, b = convert.arena_to_numpy(ours), _ref_state(theirs)
    assert set(a) == set(convert.ARENA_KEYS)
    assert len(a["extents"]) == len(b["extents"])
    for x, y in zip(a["extents"], b["extents"]):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    for k in convert.ARENA_KEYS[1:]:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ours.alloc.claims == theirs.alloc.claims
    assert ours.alloc.reuse_claims == theirs.alloc.reuse_claims
    assert ours.alloc.releases == theirs.alloc.releases
    np.testing.assert_array_equal(ours.planner.ub, theirs.planner.ub)
    assert ours.host_syncs == theirs.host_syncs
    for name in ("appends", "pool_grow_events", "table_grow_events", "peak_live_ub",
                 "pool_copied_bytes", "capacity_tokens", "live_tokens_ub"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.utilization() == pytest.approx(theirs.utilization(), rel=0, abs=0)


def _assert_flatten_same(ours, theirs):
    fo, to, so = ours.flatten()
    fr, tr, sr = theirs.flatten()
    assert int(to) == int(jax.device_get(tr))
    np.testing.assert_array_equal(_bits(convert.tensor_to_numpy(fo)), _bits(np.asarray(fr)))
    np.testing.assert_array_equal(so.numpy(), np.asarray(sr))
    np.testing.assert_array_equal(_bits(convert.tensor_to_numpy(ours.logical_view())),
                                  _bits(np.asarray(theirs.logical_view())))


def _wave(rng, n, m, item, dtype):
    x = rng.standard_normal((n, m, *item)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return x


def _pair(n, slab, item=(), dtype="float32", **kw):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return (SlabArena(n, slab, item_shape=item, dtype=tdt, device="cpu", **kw),
            RefArena(n, slab, item_shape=item, dtype=jdt, **kw))


def _settle(theirs):
    """Wait for the reference arena's dispatched work.  Its cached owner
    table is ``jnp.asarray`` of the host owner array, which on the CPU can
    share that array's memory, and its slab append runs asynchronously: a
    ``release`` or claim issued before the append has run rewrites the table
    under it.  Waiting keeps the reference's state independent of timing."""
    jax.block_until_ready((theirs.pool.extents, theirs.pool.free, theirs.arr.pages,
                           theirs.arr.sizes))


def _run_both(ours, theirs, rng, steps, item=(), dtype="float32", p_release=0.3):
    """Random releases and waves (widths 3 and 7, to bound the reference's
    compiles) through both arenas; masks alternate between host-known numpy
    and device arrays (a tensor on the port's side), so both planner paths
    and their host syncs are compared.  State is compared after each step."""
    n = ours.narrays
    for step in range(steps):
        if rng.random() < p_release:
            t = int(rng.integers(0, n))
            assert ours.release(t) == theirs.release(t)
        else:
            m = (3, 7)[int(rng.integers(0, 2))]
            elems = _wave(rng, n, m, item, dtype)
            mask = rng.random((n, m)) < 0.7
            host = step % 2 == 0
            pos_o = ours.append(convert.tensor_from_numpy(elems, "cpu"),
                                mask if host else torch.from_numpy(mask))
            pos_r = theirs.append(jnp.asarray(elems), mask if host else jnp.asarray(mask))
            np.testing.assert_array_equal(pos_o.numpy(), np.asarray(pos_r))
        _assert_state_same(ours, theirs)


@pytest.mark.parametrize("grow_chunk,item,dtype", [
    (1, (), "float32"), (1, (2, 4), "bfloat16"), ("geometric", (3,), "float32"),
    ("doubling", (), "float32"), ("doubling", (2, 4), "bfloat16"), ("tz", (), "float32"),
    ("tz", (3,), "float32"),
])
def test_interleaved_append_release_matches_reference(grow_chunk, item, dtype):
    rng = np.random.default_rng(4)
    ours, theirs = _pair(4, 4, item, dtype, grow_chunk=grow_chunk)
    _run_both(ours, theirs, rng, 8, item, dtype)
    _assert_flatten_same(ours, theirs)
    assert ours.check_invariants() == theirs.check_invariants()


def test_arena_append_matches_ggarray_bitwise():
    """Same waves → identical positions, sizes and flattened contents as a
    GGArray, with host-known masks planning no host sync."""
    rng = np.random.default_rng(0)
    arena = SlabArena(4, 8, dtype=torch.float32, device="cpu")
    ref = gg.init(4, b0=8, dtype=torch.float32, nbuckets=1, device="cpu")
    planner = gg.CapacityPlanner()
    for _ in range(10):
        m = int(rng.integers(1, 9))
        elems = torch.from_numpy(rng.standard_normal((4, m)).astype(np.float32))
        mask = rng.random((4, m)) > 0.3
        pos_a = arena.append(elems, mask)
        ref = planner.reserve(ref, m, mask=mask)
        ref, pos_g, hr = gg.append(ref, elems, torch.from_numpy(mask))
        planner.note_append(ref, hr)
        np.testing.assert_array_equal(pos_a.numpy(), pos_g.numpy())
    flat_a, tot_a, _ = arena.flatten()
    flat_g, tot_g = gg.flatten(ref)
    n = int(tot_a)
    assert n == int(tot_g)
    np.testing.assert_array_equal(flat_a[:n].numpy(), flat_g[:n].numpy())
    assert arena.host_syncs == 0
    arena.check_invariants()


def test_arena_capacity_bound():
    rng = np.random.default_rng(1)
    arena = SlabArena(6, 16, dtype=torch.float32, device="cpu")
    for _ in range(8):
        arena.append(torch.ones((6, int(rng.integers(1, 20)))))
    stats = arena.check_invariants()
    assert stats["capacity_tokens"] <= stats["live_tokens"] + 16 * 6
    assert stats["capacity_tokens"] < 2 * stats["live_tokens"] + 16 * 6


def test_arena_nonscalar_items_flatten():
    arena = SlabArena(2, 4, item_shape=(3,), dtype=torch.float32, device="cpu")
    elems = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    arena.append(elems)
    flat, total, _ = arena.flatten()
    assert int(total) == 10
    np.testing.assert_array_equal(flat[:5].numpy(), elems[0].numpy())
    np.testing.assert_array_equal(flat[5:10].numpy(), elems[1].numpy())


def test_release_then_reuse_before_growth():
    ours, theirs = _pair(3, 8)
    for a, x in ((ours, torch.ones((3, 20))), (theirs, jnp.ones((3, 20), jnp.float32))):
        a.append(x)
    _settle(theirs)
    grown_before = ours.alloc.grown_slabs
    assert ours.release(1) == theirs.release(1) == 3
    assert ours.alloc.free_count == 3
    mask = np.asarray([[True] * 16, [False] * 16, [True] * 16])
    ours.append(torch.ones((3, 16)), mask)
    theirs.append(jnp.ones((3, 16), jnp.float32), mask)
    assert ours.alloc.reuse_claims >= 3, "freed slabs must be reused"
    assert ours.alloc.grown_slabs == grown_before + 1
    _assert_state_same(ours, theirs)
    ours.check_invariants()


def test_quota_rejects_runaway_tenant():
    arena = SlabArena(2, 4, quota_slabs=2, dtype=torch.float32, device="cpu")
    arena.append(torch.ones((2, 8)))
    with pytest.raises(QuotaExceeded):
        arena.append(torch.ones((2, 4)))


def _peak_live_case(seed, grow_chunk):
    rng = np.random.default_rng(seed)
    n, slab = 4, 4
    arena = SlabArena(n, slab, dtype=torch.float32, grow_chunk=grow_chunk, device="cpu")
    peak_live = 0
    for _ in range(12):
        if rng.random() < 0.3:
            arena.release(int(rng.integers(0, n)))
        else:
            m = int(rng.integers(1, 10))
            mask = rng.random((n, m)) < 0.7
            free_before = arena.alloc.free_count
            grown_before = arena.alloc.grown_slabs
            arena.append(torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32)), mask)
            claimed = arena.alloc.grown_slabs - grown_before + free_before - arena.alloc.free_count
            if arena.alloc.grown_slabs > grown_before:
                # growth only for the shortfall: the free list was consumed
                assert arena.alloc.free_count == 0 or claimed >= free_before
        stats = arena.check_invariants()  # free xor held by exactly one array
        peak_live = max(peak_live, stats["live_tokens"])
    if grow_chunk == 1:
        assert stats["capacity_tokens"] <= peak_live + 4 * n + 4 * n
    return stats


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_interleaved_admit_grow_evict_keeps_peak_live_bound(seed):
    """Property: any interleaving of appends and releases keeps every slab
    free or held by one array, reuses freed slabs before growing, and keeps
    capacity ≤ peak live tokens + 8·narrays (demand growth)."""
    _peak_live_case(seed, 1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7, 11])
@pytest.mark.parametrize("grow_chunk", [1, "doubling"])
def test_interleaved_admit_grow_evict_seeded(seed, grow_chunk):
    """The same invariants at fixed seeds, seed 1 included (where capacity
    exceeds live tokens after releases + 8n, but not peak live + 8n)."""
    _peak_live_case(seed, grow_chunk)


def test_geometric_growth_pays_o_log_copies():
    geo = SlabArena(2, 4, dtype=torch.float32, grow_chunk="geometric", device="cpu")
    demand = SlabArena(2, 4, dtype=torch.float32, device="cpu")
    for _ in range(40):
        geo.append(torch.ones((2, 6)))
        demand.append(torch.ones((2, 6)))
    n = geo.pool.n_slabs
    assert geo.pool_grow_events <= int(np.ceil(np.log2(max(n, 2)))) + 1
    assert demand.pool_grow_events > 2 * geo.pool_grow_events
    fg, tg, _ = geo.flatten()
    fd, td, _ = demand.flatten()
    assert int(tg) == int(td)
    np.testing.assert_array_equal(fg[:int(tg)].numpy(), fd[:int(td)].numpy())
    geo.check_invariants()


def test_high_water_pre_carve_never_grows():
    arena = SlabArena(2, 4, dtype=torch.float32, initial_slabs=32, device="cpu")
    for _ in range(10):
        arena.append(torch.ones((2, 6)))
    assert arena.pool_grow_events == 0
    arena.check_invariants()


@pytest.mark.parametrize("space", ["vmem", "hbm"])
def test_memory_space_is_checked_and_inert(space):
    rng = np.random.default_rng(9)
    ours = SlabArena(3, 4, dtype=torch.float32, memory_space=space, device="cpu")
    theirs = RefArena(3, 4, dtype=jnp.float32, memory_space=space)
    _run_both(ours, theirs, rng, 6, p_release=0.0)
    _assert_flatten_same(ours, theirs)
    with pytest.raises(ValueError):
        SlabArena(3, 4, memory_space="smem", device="cpu")


def test_start_from_reference_state_then_step_both():
    """``convert.arena_from_numpy`` starts the port from the reference's
    state; the same further steps keep the two bitwise equal."""
    rng = np.random.default_rng(12)
    theirs = RefArena(5, 4, item_shape=(2,), dtype=jnp.float32, grow_chunk="doubling")
    for _ in range(3):
        m = (3, 7)[int(rng.integers(0, 2))]
        theirs.append(jnp.asarray(rng.standard_normal((5, m, 2)), jnp.float32),
                      rng.random((5, m)) < 0.8)
        _settle(theirs)
    theirs.release(2)
    ours = convert.arena_from_numpy(_ref_state(theirs), device="cpu", grow_chunk="doubling",
                                    live_ub=theirs.planner.ub)
    np.testing.assert_array_equal(ours.book.npages, theirs.book.npages)
    np.testing.assert_array_equal(ours.book.page_of_slab, theirs.book.page_of_slab)
    assert ours.book.pages_of == theirs.book.pages_of
    for _ in range(5):
        if rng.random() < 0.25:
            t = int(rng.integers(0, 5))
            assert ours.release(t) == theirs.release(t)
        else:
            m = (3, 7)[int(rng.integers(0, 2))]
            elems = rng.standard_normal((5, m, 2)).astype(np.float32)
            mask = rng.random((5, m)) < 0.8
            np.testing.assert_array_equal(
                ours.append(torch.from_numpy(elems), mask).numpy(),
                np.asarray(theirs.append(jnp.asarray(elems), mask)))
        a, b = convert.arena_to_numpy(ours), _ref_state(theirs)
        for x, y in zip(a["extents"], b["extents"]):
            np.testing.assert_array_equal(x, y)
        for k in convert.ARENA_KEYS[1:]:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _assert_flatten_same(ours, theirs)
    ours.check_invariants()


def test_metrics_registered_as_the_reference():
    ours, theirs = _pair(3, 4, grow_chunk="tz")
    for a, x in ((ours, torch.ones((3, 9))), (theirs, jnp.ones((3, 9), jnp.float32))):
        a.append(x)
    snap_o, snap_r = ours.registry.snapshot(), theirs.registry.snapshot()
    pool_keys = sorted(k for k in snap_r if k.startswith(("pool.", "arena.")))
    assert sorted(k for k in snap_o if k.startswith(("pool.", "arena."))) == pool_keys
    for k in pool_keys:
        assert snap_o[k] == snap_r[k], k


def test_page_groups_and_containers():
    assert geometric_page_groups(10) == [(0, 1), (1, 3), (3, 7), (7, 10)]
    pool = arena_mod.init_pool(3, 4, (2,), device="cpu")
    grown = arena_mod.grow_pool(pool, 5)
    assert grown.n_slabs == 8 and grown.capacity_tokens == 32 and grown.item_shape == (2,)
    assert bool(grown.free.all())
    arr = ArenaGGArray(pages=torch.full((3, 4), -1, dtype=torch.int32),
                       sizes=torch.zeros(3, dtype=torch.int32))
    assert arr.narrays == 3 and arr.max_pages == 4


def test_constructor_knobs():
    # instrument=True: each append hands its counter vector to the plane
    inst = SlabArena(2, 4, instrument=True, device="cpu")
    inst.append(torch.ones((2, 3)), np.asarray([[1, 1, 0], [1, 0, 0]], bool))
    got = inst.devctr.counters()
    assert (got["slab_append.waves"], got["slab_append.lanes"], got["slab_append.active_lanes"]) == (
        1.0, 6.0, 3.0)
    with pytest.raises(ValueError):
        SlabArena(2, 0, device="cpu")
    with pytest.raises(ValueError):
        SlabArena(2, 4, dispatch="nope", device="cpu")
    with pytest.raises(ValueError):
        SlabArena(2, 4, device="cpu").append(torch.ones((3, 2)))
    a = SlabArena(2, 4, device="cpu")
    assert a.append(torch.ones((2, 0))).shape == (2, 0)


@pytest.mark.parametrize("corrupt,match", [
    ("bitmap", "device bitmap drifted"),
    ("stray", "stray pages|free slab present"),
    ("size", "overflow|bound lies"),
])
def test_check_invariants_raises_on_drift(corrupt, match):
    """A device state that drifts from the host mirrors raises the
    reference's ``AssertionError``s, after a flight-recorder bundle."""
    arena = SlabArena(3, 4, dtype=torch.float32, device="cpu")
    arena.append(torch.ones((3, 5)))
    arena.release(2)
    if corrupt == "bitmap":
        arena.pool.free[0] = ~arena.pool.free[0]
    elif corrupt == "stray":
        arena.arr.pages[2, 0] = int(np.flatnonzero(arena.alloc.free)[0])
    else:
        arena.arr.sizes[0] = 99
    with pytest.raises(AssertionError, match=match):
        arena.check_invariants()
    assert arena.flight.last_bundle["reason"] == "arena_invariant"
