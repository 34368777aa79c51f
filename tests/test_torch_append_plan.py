"""The host-side plans of the two append kernels and the index arithmetic of
their passes: K3, the fused push-back (``kernels/push_back/kernel.py``,
``csrc/push_back.cu``), and K12, the slab append (``kernels/paged/kernel.py``,
``csrc/paged.cu``), both on the tile-parallel row scan of
``csrc/common.cuh``.  The kernels run only on a card; these tests replay
what each block computes (tile counts, tile prefixes and ranks, K12's
segment search and slab windows, K3's per-tile counters) in numpy on seeded
inputs and hold it against the plain versions (``ref.py``): every position
right, every live lane written exactly once per claiming slab (K12) or into
exactly one level slot (K3), and K3's per-tile counters summing to the
reference's per-row counters."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import indexing
from repro_torch.kernels import common
from repro_torch.kernels.paged import kernel as k_pg
from repro_torch.kernels.paged import ref as r_pg
from repro_torch.kernels.push_back import kernel as k_pb
from repro_torch.kernels.push_back import ref as r_pb
from repro_torch.obs import device as obs_device


def _mask(rng, rows, m, p_live):
    return rng.random((rows, m)) < p_live


# ---------------------------------------------------------------------------
# the plan: block sizes and tiles from shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,work,threads", [
    (1, 64, 64),  # the Engine's decode append: k and v, 32 16-byte units each
    (1, 96, 128), (1, 128, 128), (2, 256, 256),
    (1, 1, 64), (64, 64, 64), (1024, 0, 64), (1025, 0, 128), (2048, 0, 128), (2049, 0, 256),
    (262_144, 262_144, 256),  # the main grow wave
    (16_384, 0, 256),  # the KV prefill wave's scan
])
def test_scan_threads_from_lanes_and_units(m, work, threads):
    assert common.scan_threads(m, work) == threads


@pytest.mark.parametrize("m,threads,tiles", [
    (1, 64, 1), (1024, 64, 1), (1025, 64, 2), (4095, 256, 1), (4096, 256, 1), (4097, 256, 2),
    (262_144, 256, 64), (0, 256, 1),
])
def test_row_tiles(m, threads, tiles):
    assert common.row_tiles(m, threads) == tiles


def test_push_back_plan_regimes():
    # one launch at m = 1; a count pass first at the main grow wave
    assert k_pb.push_back_plan(1, 64) == k_pb.PushBackPlan(64, 1, False)
    assert k_pb.push_back_plan(262_144, 1) == k_pb.PushBackPlan(256, 64, True)
    assert k_pb.push_back_plan(4096, 1) == k_pb.PushBackPlan(256, 1, False)
    assert k_pb.push_back_plan(4097, 1) == k_pb.PushBackPlan(256, 2, True)


@pytest.mark.parametrize("m,item_bytes,T,want", [
    (262_144, 4, 2048, k_pg.AppendPlan(256, 64, True, 256, 2048, 1)),  # the scalar arena's grow wave
    (16_384, 2048, 2048, k_pg.AppendPlan(256, 4, True, 16, 16, 128)),  # the KV prefill wave
    (1, 4, 5, k_pg.AppendPlan(64, 1, False, 1, 5, 1)),
    (700, 2048, 100, k_pg.AppendPlan(64, 1, False, 1, 16, 7)),  # a ragged last chunk
    (37, 3, 4096, k_pg.AppendPlan(64, 1, False, 1, 2048, 2)),  # chunks capped at 2048 slots
    (10, 1 << 20, 64, k_pg.AppendPlan(64, 1, False, 1, 1, 64)),  # items past a chunk's bytes
])
def test_append_plan(m, item_bytes, T, want):
    plan = k_pg.append_plan(m, item_bytes, T)
    assert plan == want
    assert 1 <= plan.chunk <= k_pg.APPEND_MAX_CHUNK and (plan.chunks - 1) * plan.chunk < T <= plan.chunks * plan.chunk


# ---------------------------------------------------------------------------
# the row scan: tile counts, tile prefixes, ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threads", common.SCAN_THREADS)
@pytest.mark.parametrize("m", [1, 1023, 1024, 1025, 4095, 4096, 4097, 3 * 4096 + 5])
@pytest.mark.parametrize("p_live", [0.0, 0.6, 1.0])
def test_tile_ranks_are_the_exclusive_scan(threads, m, p_live):
    rng = np.random.default_rng(m + threads)
    mask = _mask(rng, 3, m, p_live)
    counts = common.tile_counts(mask, threads)
    assert counts.shape == (3, common.row_tiles(m, threads))
    assert (counts.sum(1) == mask.sum(1)).all()
    ranks, prefix = common.tile_ranks(mask, threads)
    inclusive = np.cumsum(mask, 1)
    np.testing.assert_array_equal(ranks, inclusive - mask)
    np.testing.assert_array_equal(prefix[:, -1], mask.sum(1))
    np.testing.assert_array_equal(prefix[:, :-1], np.cumsum(counts, 1) - counts)


# ---------------------------------------------------------------------------
# K3: positions, level slots and per-tile counters
# ---------------------------------------------------------------------------

def _k3_replay(mask, sizes, b0, nlevels, threads):
    """What K3's blocks compute → (positions, {(row, level, slot): lane},
    per-tile counter contributions (waves, lanes, active, level writes))."""
    rows, m = mask.shape
    ranks, prefix = common.tile_ranks(mask, threads)
    tl = threads * common.SCAN_PER
    tiles = common.row_tiles(m, threads)
    pos = np.where(mask, sizes[:, None] + ranks, -1)
    slots, written = {}, np.zeros((rows, indexing.capacity(b0, nlevels)), np.int64)
    contrib = []
    for row in range(rows):
        for t in range(tiles):
            lanes = np.arange(t * tl, min((t + 1) * tl, m))
            for lane in lanes[mask[row, lanes]]:
                p = int(sizes[row] + ranks[row, lane])
                level = (p // b0 + 1).bit_length() - 1
                if level < nlevels:
                    slot = p - b0 * ((1 << level) - 1)
                    assert 0 <= slot < b0 << level
                    slots[(row, level, slot)] = lane
                    written[row, p] += 1
            c = [int(row == 0 and t == 0), len(lanes), int(prefix[row, t + 1] - prefix[row, t]), 0]
            if t == tiles - 1:  # the last tile knows size and total
                lo, hi = int(sizes[row]), int(sizes[row] + prefix[row, -1])
                for lv in range(nlevels):
                    start = b0 * ((1 << lv) - 1)
                    c[3] += max(min(hi, start + (b0 << lv)) - max(lo, start), 0)
            contrib.append(c)
    assert written.max(initial=0) <= 1  # a level slot takes one lane at most
    return pos, slots, np.asarray(contrib, np.int64)


@pytest.mark.parametrize("m,p_live", [(1, 1.0), (1, 0.5), (130, 0.6), (4095, 0.7), (4096, 1.0),
                                      (4097, 0.6), (3 * 4096 + 5, 0.0), (20_000, 0.9)])
@pytest.mark.parametrize("b0,nlevels", [(2, 9), (16, 6), (1, 12)])
def test_push_back_replay_matches_plain_version(m, p_live, b0, nlevels):
    rng = np.random.default_rng(m * 7 + b0)
    rows = 4
    cap = indexing.capacity(b0, nlevels)
    sizes = rng.integers(0, cap + 8, rows).astype(np.int64)
    sizes[0] = b0 * 3  # a level boundary (b0 (2^2 - 1))
    mask = _mask(rng, rows, m, p_live)
    threads = k_pb.push_back_plan(m, 1).threads
    pos, slots, contrib = _k3_replay(mask, sizes, b0, nlevels, threads)

    elems = torch.from_numpy(rng.standard_normal((rows, m)).astype(np.float32))
    levels = tuple(torch.zeros((rows, w)) for w in indexing.bucket_sizes(b0, nlevels))
    sizes_t = torch.from_numpy(sizes.astype(np.int32))
    mask_t = torch.from_numpy(mask)
    _, new_sizes, want_pos = r_pb.push_back(levels, sizes_t, b0, elems, mask_t)
    np.testing.assert_array_equal(pos, want_pos.numpy())
    np.testing.assert_array_equal(sizes + mask.sum(1), new_sizes.numpy())
    # every slot the replay writes holds its lane's item in the plain
    # version, and the plain version writes no other slot
    replayed = tuple(torch.zeros_like(lv) for lv in levels)
    for (row, level, slot), lane in slots.items():
        replayed[level][row, slot] = elems[row, lane]
    for a, b in zip(replayed, levels):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # the per-tile counters sum to the plain twin's per-row counters
    want = r_pb.counters(mask_t, sizes_t, b0, nlevels)
    got = obs_device.pack(torch.device("cpu"), **{
        "push_back.waves": int(contrib[:, 0].sum()), "push_back.lanes": int(contrib[:, 1].sum()),
        "push_back.active_lanes": int(contrib[:, 2].sum()),
        "push_back.level_writes": int(contrib[:, 3].sum())})
    assert torch.equal(got, want)
    assert contrib[:, 0].sum() == 1  # block 0 counts the wave


# ---------------------------------------------------------------------------
# K12: the scan pass's segment prefix and the slab-major copy
# ---------------------------------------------------------------------------

def _k12_replay(pool, owners, bases, sizes, mask, elems, T):
    """What K12's passes compute → (positions, new sizes, pool after the copy,
    lanes copied per (slab, slot))."""
    N, m = mask.shape
    plan = k_pg.append_plan(m, elems.dtype.itemsize, T)
    ranks, _ = common.tile_ranks(mask, plan.threads)
    pos = np.where(mask, sizes[:, None] + ranks, -1)
    # the scan pass: each segment's first lane's rank, then the count
    seg = np.zeros((N, plan.segments + 1), np.int64)
    seg[:, :-1] = ranks[:, ::k_pg.APPEND_SEG_LANES]
    seg[:, -1] = mask.sum(1)
    out = pool.copy()
    copies = np.zeros(pool.shape, np.int64)
    for s in range(len(owners)):
        if owners[s] < 0:
            continue
        own = min(int(owners[s]), N - 1)
        size, count, base = int(sizes[own]), int(seg[own, -1]), int(bases[s])
        for c in range(plan.chunks):
            j_lo, j_hi = k_pg.slab_window(c, plan.chunk, T, base, size, count)
            assert j_hi - j_lo <= plan.chunk
            if j_lo >= j_hi:
                continue
            r_lo, r_hi = base + j_lo - size, base + j_hi - size
            assert 0 <= r_lo < r_hi <= count
            g0, g1 = k_pg.rank_segments(seg[own], r_lo, r_hi)
            lanes = np.arange(g0 * k_pg.APPEND_SEG_LANES, min(g1 * k_pg.APPEND_SEG_LANES, m))
            live = lanes[mask[own, lanes]]
            r = seg[own, g0] + np.arange(len(live))  # the re-scan's ranks
            pick = live[(r >= r_lo) & (r < r_hi)]
            assert len(pick) == j_hi - j_lo  # the segments hold every rank of the window
            np.testing.assert_array_equal(ranks[own, pick], np.arange(r_lo, r_hi))
            out[s, j_lo:j_hi] = elems[own, pick]
            copies[s, j_lo:j_hi] += 1
    return pos, sizes + mask.sum(1), out, copies


def _k12_check(pool, owners, bases, sizes, mask, elems, T):
    pos, new_sizes, out, copies = _k12_replay(pool, owners, bases, sizes, mask, elems, T)
    want_pool, want_sizes, want_pos = r_pg.slab_append(
        torch.from_numpy(pool[:, :, None]), torch.from_numpy(owners), torch.from_numpy(bases),
        torch.from_numpy(sizes.astype(np.int32)), torch.from_numpy(elems[:, :, None]), torch.from_numpy(mask))
    np.testing.assert_array_equal(pos, want_pos.numpy())
    np.testing.assert_array_equal(new_sizes, want_sizes.numpy())
    np.testing.assert_array_equal(out.view(np.int32), want_pool[:, :, 0].numpy().view(np.int32))
    assert copies.max(initial=0) <= 1  # each slot of each slab written at most once
    # every live lane lands once in each slab that claims its position
    N = mask.shape[0]
    claimed = np.zeros_like(copies)
    for s in range(len(owners)):
        if owners[s] >= 0:
            own = min(int(owners[s]), N - 1)
            j = np.arange(T)
            rank = bases[s] + j - sizes[own]
            claimed[s] = (rank >= 0) & (rank < mask[own].sum())
    np.testing.assert_array_equal(copies, claimed)


def _arena(rng, N, T, sizes, mask, short=0):
    """Tables as the arena builds them, covering each array's wave less
    ``short`` slabs, over a shuffled pool with three free slabs."""
    after = sizes + mask.sum(1)
    npages = [max(-(-int(a) // T) - short, 0) for a in after]
    S = sum(npages) + 3
    perm = rng.permutation(S)
    owners = np.full(S, -1, np.int32)
    bases = np.zeros(S, np.int32)
    k = 0
    for i, c in enumerate(npages):
        ids = perm[k:k + c]
        k += c
        owners[ids] = i
        bases[ids] = np.arange(c) * T
    return owners, bases


@pytest.mark.parametrize("m", [1, 1023, 1024, 1025, 2048, 2049, 4095, 4096, 4097, 20_000])
@pytest.mark.parametrize("p_live", [0.0, 0.7, 1.0])
def test_slab_append_replay_arena_tables(m, p_live):
    rng = np.random.default_rng(m + int(10 * p_live))
    N, T = 3, 64
    mask = _mask(rng, N, m, p_live)
    sizes = rng.integers(0, 3 * T, N).astype(np.int64)
    owners, bases = _arena(rng, N, T, sizes, mask, short=1 if p_live == 0.7 else 0)
    pool = rng.standard_normal((len(owners), T)).astype(np.float32)
    elems = rng.standard_normal((N, m)).astype(np.float32)
    _k12_check(pool, owners, bases, sizes, mask, elems, T)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("m", [37, 1100, 4097])
def test_slab_append_replay_fuzzed_tables(seed, m):
    """Free slabs, owners past N (clamped), overlapping windows, misaligned
    bases, lanes past every slab."""
    rng = np.random.default_rng(100 * seed + m)
    N, T, P, S = 7, 5, 40, 40
    mask = _mask(rng, N, m, 0.7)
    sizes = rng.integers(0, 3 * T, N).astype(np.int64)
    owners = rng.integers(-1, N + 1, S).astype(np.int32)
    bases = (rng.integers(0, P, S) * T + rng.integers(-1, 2, S) * rng.integers(0, 2, S)).astype(np.int32)
    pool = rng.standard_normal((S, T)).astype(np.float32)
    elems = rng.standard_normal((N, m)).astype(np.float32)
    _k12_check(pool, owners, bases, sizes, mask, elems, T)


def test_slab_append_replay_sparse_mask_spans_many_tiles():
    """At 0.4 % density a 128-slot window's ranks lie in about eight
    4096-lane tiles: the segment search returns all of them."""
    rng = np.random.default_rng(7)
    N, T, m = 3, 128, 60_000
    mask = _mask(rng, N, m, 0.004)
    sizes = rng.integers(0, 300, N).astype(np.int64)
    owners, bases = _arena(rng, N, T, sizes, mask)
    pool = rng.standard_normal((len(owners), T)).astype(np.float32)
    elems = rng.standard_normal((N, m)).astype(np.float32)
    _k12_check(pool, owners, bases, sizes, mask, elems, T)
    # and the windows did span many segments
    plan = k_pg.append_plan(m, 4, T)
    ranks, _ = common.tile_ranks(mask, plan.threads)
    seg = np.concatenate([ranks[0, ::k_pg.APPEND_SEG_LANES], [mask[0].sum()]])
    g0, g1 = k_pg.rank_segments(seg, 0, min(T, int(mask[0].sum())))
    assert g1 - g0 >= 4


@pytest.mark.parametrize("seg,r_lo,r_hi,want", [
    ([0, 10, 20, 30], 0, 30, (0, 3)),
    ([0, 10, 20, 30], 10, 11, (1, 2)),
    ([0, 10, 20, 30], 9, 11, (0, 2)),
    ([0, 0, 0, 5, 5, 9], 0, 5, (2, 3)),  # empty segments before and after
    ([0, 0, 0, 5, 5, 9], 5, 9, (4, 5)),
    ([0, 3], 0, 3, (0, 1)),
])
def test_rank_segments(seg, r_lo, r_hi, want):
    assert k_pg.rank_segments(seg, r_lo, r_hi) == want
