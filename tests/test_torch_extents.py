"""Port of the segmented extent pool (``repro.pool.extents``), mirroring
``tests/pool/test_extents.py`` and held against the JAX package: the growth
schedules, the two-level tables and page resolution agree bitwise; growth
keeps every existing extent by identity (the same tensor, the same
``data_ptr()``, where the reference spies ``unsafe_buffer_pointer``); and
the kernels' extent table (``kernels/common.extent_table``) holds the
extents' addresses and the ``slab_tables`` prefix.  No tolerance: all
results are integers or moved bits."""
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
from repro.pool import extents as ref
from repro_torch.kernels import common
from repro_torch.pool import SlabArena
from repro_torch.pool import extents as port
from repro_torch.pool.planner import SlabAllocator


def _ptrs(pool):
    return [e.data_ptr() for e in pool.extents]


@pytest.mark.parametrize("schedule", port.EXTENT_SCHEDULES)
@pytest.mark.parametrize("existing,short,reserved", [
    ((), 1, 0), ((4,), 1, 0), ((4, 4), 3, 0), ((4,), 1, 9), ((1, 2, 2), 4, 0),
    ((1, 2, 2), 5, 0), ((1,), 2, 3), ((0,), 3, 0), ((3, 1, 5, 2), 0, 0),
])
def test_plan_extents_matches(schedule, existing, short, reserved):
    assert port.plan_extents(existing, short, schedule, reserved=reserved) == \
        ref.plan_extents(existing, short, schedule, reserved=reserved)


def test_plan_doubling_and_tz_examples():
    assert port.plan_extents((4,), 1, "doubling") == [4]
    assert port.plan_extents((4,), 1, "doubling", reserved=9) == [13]
    assert [port._tz_size(j) for j in range(11)] == [1, 2, 2, 2, 4, 4, 4, 4, 4, 4, 8]
    assert [port._tz_size(j) for j in range(200)] == [ref._tz_size(j) for j in range(200)]
    with pytest.raises(ValueError):
        port.plan_extents((1,), 1, "nope")


def test_tz_waste_is_o_sqrt_n():
    sizes: list[int] = []
    for short in [1, 3, 7, 20, 50, 200]:
        sizes += port.plan_extents(tuple(sizes), short, "tz")
        assert sizes[-1] <= 2 * int(np.sqrt(sum(sizes))) + 1


@pytest.mark.parametrize("schedule", port.EXTENT_SCHEDULES)
def test_grow_extents_keeps_tensors_by_identity(schedule):
    """Growth never touches existing extents: same objects, same pointers,
    same bits; the free bitmap grows by the new slabs."""
    pool = port.init_extent_pool(2, 4, (3,), torch.float32, device="cpu")
    pool.extents[0].copy_(torch.arange(24, dtype=torch.float32).reshape(2, 4, 3))
    for wave in range(5):
        before, ptrs = pool.extents, _ptrs(pool)
        pool = port.grow_extents(pool, port.plan_extents(pool.extent_sizes, wave + 1, schedule))
        for i, old in enumerate(before):
            assert pool.extents[i] is old, "existing extent was rebuilt"
            assert pool.extents[i].data_ptr() == ptrs[i]
        assert pool.free.shape == (pool.n_slabs,) and bool(pool.free.all())
    np.testing.assert_array_equal(pool.extents[0].numpy(), np.arange(24).reshape(2, 4, 3))


@pytest.mark.parametrize("schedule", port.EXTENT_SCHEDULES)
def test_grow_extents_matches_reference_geometry(schedule):
    ours = port.init_extent_pool(0, 4, (), torch.float32, device="cpu")
    theirs = ref.init_extent_pool(0, 4, (), jnp.float32)
    for short in (1, 3, 2, 9, 1, 17):
        ours = port.grow_extents(ours, port.plan_extents(ours.extent_sizes, short, schedule))
        theirs = ref.grow_extents(theirs, ref.plan_extents(theirs.extent_sizes, short, schedule))
        assert ours.extent_sizes == theirs.extent_sizes
        assert ours.bases == theirs.bases and ours.n_slabs == theirs.n_slabs
        assert ours.capacity_tokens == theirs.capacity_tokens


def test_grow_flat_reallocates():
    pool = port.init_extent_pool(2, 4, (), torch.float32, device="cpu")
    ptr = pool.extents[0].data_ptr()
    grown = port.grow_flat(pool, 4)
    assert grown.n_extents == 1 and grown.n_slabs == 6
    assert grown.extents[0].data_ptr() != ptr
    with pytest.raises(ValueError):
        port.grow_flat(port.grow_extents(grown, [2]), 1)


@pytest.mark.parametrize("schedule", port.EXTENT_SCHEDULES)
def test_arena_extent_growth_is_zero_copy(schedule):
    arena = SlabArena(3, 4, dtype=torch.float32, grow_chunk=schedule, device="cpu")
    rng = np.random.default_rng(0)
    first_ptr = None
    for _ in range(8):
        m = int(rng.integers(1, 10))
        arena.append(torch.from_numpy(rng.standard_normal((3, m)).astype(np.float32)))
        if first_ptr is None and arena.pool.n_slabs:
            first_ptr = arena.pool.extents[0].data_ptr()
    assert arena.pool_grow_events >= 2
    assert arena.pool_copied_bytes == 0
    assert arena.pool.n_extents > 1
    assert arena.pool.extents[0].data_ptr() == first_ptr
    arena.check_invariants()


def test_arena_flat_growth_copies_bytes_as_the_reference_counts():
    ours = SlabArena(3, 4, dtype=torch.float32, grow_chunk=1, device="cpu")
    theirs = RefArena(3, 4, dtype=jnp.float32, grow_chunk=1)
    for _ in range(4):
        ours.append(torch.ones((3, 6)))
        theirs.append(jnp.ones((3, 6), jnp.float32))
    assert ours.pool_copied_bytes == theirs.pool_copied_bytes > 0


@pytest.mark.parametrize("sizes", [(1,), (1, 2, 2), (4, 4, 8), (3, 1, 5, 2)])
def test_slab_tables_match_and_round_trip(sizes):
    ext_p, off_p = port.slab_tables(sizes)
    ext_r, off_r = ref.slab_tables(sizes)
    np.testing.assert_array_equal(ext_p, ext_r)
    np.testing.assert_array_equal(off_p, off_r)
    bases = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    np.testing.assert_array_equal(bases[ext_p] + off_p, np.arange(sum(sizes)))


@given(st.lists(st.integers(min_value=1, max_value=16), min_size=1, max_size=8))
@settings(max_examples=50, deadline=None)
def test_slab_tables_match_property(sizes):
    ext_p, off_p = port.slab_tables(tuple(sizes))
    ext_r, off_r = ref.slab_tables(tuple(sizes))
    np.testing.assert_array_equal(ext_p, ext_r)
    np.testing.assert_array_equal(off_p, off_r)


@pytest.mark.parametrize("sizes", [(1, 2, 2), (5,), (3, 1, 5, 2)])
def test_resolve_pages_matches(sizes):
    n = sum(sizes)
    pages = np.asarray([[0, 2, -1, n - 1], [n, -1, n + 7, 1]], np.int32)
    ext_p, off_p = port.resolve_pages(torch.from_numpy(pages), sizes)
    ext_r, off_r = ref.resolve_pages(jnp.asarray(pages), sizes)
    np.testing.assert_array_equal(ext_p.numpy(), np.asarray(ext_r))
    np.testing.assert_array_equal(off_p.numpy(), np.asarray(off_r))


@pytest.mark.parametrize("schedule", port.EXTENT_SCHEDULES)
@pytest.mark.parametrize("seed", range(3))
def test_table_round_trips_under_claim_release_grow(schedule, seed):
    rng = np.random.default_rng(seed)
    alloc = SlabAllocator(0)
    sizes: list[int] = []
    live: dict[int, np.ndarray] = {}
    for tenant in range(20):
        k = int(rng.integers(1, 6))
        short = alloc.shortfall(k)
        if short:
            new = port.plan_extents(tuple(sizes), short, schedule)
            sizes += new
            alloc.grow(sum(new))
        live[tenant] = alloc.claim(tenant, k)
        if live and rng.random() < 0.4:
            alloc.release(live.pop(int(rng.choice(list(live)))))
        assert sum(sizes) == alloc.n_slabs
        held = np.concatenate(list(live.values())) if live else np.empty(0, np.int32)
        assert len(set(held.tolist())) == len(held)
        ext, off = port.resolve_pages(torch.from_numpy(held.astype(np.int32))[None], tuple(sizes))
        assert bool((ext >= 0).all()) and bool((off >= 0).all())


@pytest.mark.parametrize("sizes", [(3,), (1, 2, 2, 4), (5, 0, 7)])
def test_extent_table_holds_addresses_and_prefix(sizes):
    """The kernels' table: E base addresses, then the E + 1 slab-id starts;
    built once per geometry (a second call returns the cached tensor)."""
    exts = tuple(torch.zeros((s, 4, 2)) for s in sizes)
    table = common.extent_table(exts)
    assert table.dtype == torch.int64 and table.shape == (2 * len(sizes) + 1,)
    got = table.numpy()
    np.testing.assert_array_equal(got[:len(sizes)].view(np.uint64),
                                  np.asarray([e.data_ptr() for e in exts], np.uint64))
    np.testing.assert_array_equal(got[len(sizes):], np.concatenate([[0], np.cumsum(sizes)]))
    assert common.extent_table(exts) is table
    grown = exts + (torch.zeros((2, 4, 2)),)
    assert common.extent_table(grown) is not table


def test_extent_pool_properties_match():
    ours = port.grow_extents(port.init_extent_pool(2, 4, (3, 2), torch.bfloat16, device="cpu"),
                             [4, 8])
    theirs = ref.grow_extents(ref.init_extent_pool(2, 4, (3, 2), jnp.bfloat16), [4, 8])
    for name in ("extent_sizes", "bases", "n_extents", "n_slabs", "slab_size", "item_shape",
                 "capacity_tokens"):
        assert getattr(ours, name) == tuple(getattr(theirs, name)) if isinstance(
            getattr(theirs, name), tuple) else getattr(ours, name) == getattr(theirs, name), name
    assert ours.dtype == torch.bfloat16 and ours.data.shape == tuple(theirs.data.shape)
    assert port.is_extent_schedule("tz") and not port.is_extent_schedule(1)
    assert not port.is_extent_schedule("geometric")
