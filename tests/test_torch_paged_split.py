"""The host-side plans of the paged kernels (``kernels/paged/kernel.py``):
the gather's work plan (K8/K9, ``gather_plan``) and the paged attention's
split count, buffers and split bounds (K10/K11, ``attend_splits``,
``attend_buffers``).  The kernels run only on a card; these tests replay
their index arithmetic (``csrc/paged.cu``, ``csrc/paged_attend.cu``) in
numpy and hold it against the plain versions' semantics: every output byte
of a gather written once, every live key of an attention read by exactly one
split, every page counted by exactly one block."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged import kernel as k_pg
from repro_torch.kernels.paged import ref as r_pg
from repro_torch.obs import device as obs_device


# ---------------------------------------------------------------------------
# K8/K9: the gather's work plan
# ---------------------------------------------------------------------------

def replay_gather(plan: k_pg.GatherPlan) -> tuple[np.ndarray, np.ndarray]:
    """The pieces each block writes and the pages it counts, as the kernel
    computes them → (output piece of every write, page of every count).
    Block b takes pieces [512 b, 512 (b + 1)) ∩ [0, pieces); it resolves pages
    first // su .. last // su, and counts those whose first piece (page ·
    su) lies in the range; thread t writes pieces 512 b + 256 j + t, j < 2,
    from page p0 + local // su at local % su, local = i − p0 · su."""
    su, bp = plan.slab_units, k_pg.GATHER_BLOCK_PIECES
    b = np.arange(plan.grid)
    first = b * bp
    last = np.minimum(first + bp, plan.pieces) - 1
    p0, p1 = first // su, last // su
    assert ((p1 - p0 + 1) <= bp + 1).all()  # the block's page table in shared memory
    counted = [p for k in range(len(b)) for p in range(p0[k], p1[k] + 1) if p * su >= first[k]]
    i = (first[:, None] + (np.arange(2)[:, None] * 256 + np.arange(256)[None, :]).ravel()[None, :])
    ok = i <= last[:, None]
    local = i - (p0 * su)[:, None]
    assert (local[ok] < bp + su).all() and (local[ok] < 2 ** 32).all()  # 32-bit in the kernel
    lp = local // su
    assert ((lp <= (p1 - p0)[:, None]) | ~ok).all()
    page, off = p0[:, None] + lp, local - lp * su
    return (page * su + off)[ok], np.asarray(counted, np.int64)


@pytest.mark.parametrize("npages,slab_bytes,unit", [
    (121_856 // 64, 1024, 16),  # K8's 1 KB slabs (a 64th of its pages): eight pages a block
    (1, 1024, 16),  # a single page
    (133, 256, 16),  # N·P no multiple of a block's pages
    (500, 8192, 16),  # K9's 8 KB slabs: one page a block
    (3, 4 << 20, 16),  # the KV view's 4 MB slabs: 512 blocks a page
    (7, 9600, 16),  # 600 pieces: pages straddle blocks
    (117, 20, 4), (117, 10, 2), (117, 5, 1), (40, 4, 4),  # 4-, 2- and 1-byte pieces
    (238, 1024, 16),  # one row of K8's page table
    (1, 4 << 20, 16),  # a single 4 MB page: 512 blocks
    (2, 16, 16), (1000, 16, 16),  # one piece a page: 512 pages a block
    (513, 8192 + 16, 16),  # 513 pieces a slab: one page's end in every block
    (9, 1536, 16),  # 96 pieces a slab: no power of two
    (4, 1 << 20, 4),  # 1 MB slabs of 4-byte pieces: 512 blocks a page
    (1, 8192, 1),  # 1-byte pieces, one page: 16 blocks
    (3, 2, 2), (5, 6, 2), (11, 12, 4),  # a few small pieces a page
    (512, 64, 16),  # four pieces a page
])
def test_gather_plan_writes_each_page_byte_once(npages, slab_bytes, unit):
    plan = k_pg.gather_plan(npages, slab_bytes, unit)
    assert plan.slab_units * unit == slab_bytes and plan.pieces == npages * plan.slab_units
    assert (plan.grid - 1) * k_pg.GATHER_BLOCK_PIECES < plan.pieces <= plan.grid * k_pg.GATHER_BLOCK_PIECES
    pieces, counted = replay_gather(plan)
    counts = np.bincount(pieces, minlength=plan.pieces)
    assert len(counts) == plan.pieces and (counts == 1).all()
    # every page counted (live or masked tile) by exactly one block
    assert np.array_equal(np.sort(counted), np.arange(npages))


def test_gather_plan_sizes_blocks_by_bytes_not_pages():
    """A block copies 8 KB of 16-byte pieces whatever the slab: K8's 121,856
    1 KB pages take 15,232 blocks (eight pages each), not one block a page."""
    plan = k_pg.gather_plan(121_856, 1024, 16)
    assert (plan.slab_units, plan.grid) == (64, 15_232)
    assert k_pg.gather_plan(3, 4 << 20, 16).grid == 3 * 512


def test_gather_counters_per_page_match_the_plain_twin():
    """The kernel's count (one per page, by the block holding its first
    piece: live if the id resolves) is ``ref.gather_counters``, flat
    (clipped) and through extents."""
    rng = np.random.default_rng(0)
    S = 11
    pages = torch.from_numpy(rng.integers(-1, S + 3, (9, 13)).astype(np.int32))
    for clip in (True, False):
        for slab_bytes in (1024, 9600):
            plan = k_pg.gather_plan(pages.numel(), slab_bytes, 16)
            _, counted = replay_gather(plan)
            ids = pages.flatten().numpy()[counted]
            if clip:
                ids = np.where(ids >= S, S - 1, ids)
            live = int(((ids >= 0) & (ids < S)).sum())
            want = r_pg.gather_counters(pages, S, clip)
            got = obs_device.pack(pages.device, **{
                "paged_gather.launches": 1, "paged_gather.tiles": live,
                "paged_gather.masked_tiles": len(ids) - live})
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K10/K11: the split by the live length
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,T,bkh,sms,want", [
    (3, 2048, 16, 132, 33),  # the serving shape: q (8, 2, 8, 128), pages (8, 3): 4 blocks a SM
    (20, 64, 14, 132, 37),
    (1, 8, 5, 132, 1),  # a short table: one split per 32 positions
    (3, 10, 5, 132, 1),
    (0, 2048, 8, 132, 1),
    (1 << 10, 2048, 1, 132, k_pg.ATTEND_MAX_SPLITS),
    (64, 2048, 1000, 132, 1),  # more (sequence, head) pairs than resident blocks
])
def test_attend_split_count_comes_from_shapes_alone(P, T, bkh, sms, want):
    ns = k_pg.attend_splits(P, T, bkh, sms)
    assert ns == want and 1 <= ns <= k_pg.ATTEND_MAX_SPLITS
    assert ns <= max(1, -(-P * T // k_pg.ATTEND_SPLIT_KEYS))


def chunk_keys(D: int, esize: int) -> int:
    """Keys a chunk of the kernel's ring holds (csrc/paged_attend.cu Chunk)."""
    return min(8192 // (D * esize), 64)


def replay_attend(pages: np.ndarray, lengths: np.ndarray, T: int, n_slabs: int, clip: bool,
                  nsplit: int, D: int, esize: int) -> dict:
    """The keys each split block reads, as the kernel computes them → {(b,
    split): [(position, slab), ...]}: len clamped to [0, P·T], keys [len·i /
    nsplit, len·(i+1) / nsplit) in chunks of ``chunk_keys``, each row's page
    resolved (clipped through one flat pool, else skipped past the pool;
    page -1 skipped)."""
    B, P = pages.shape
    K = chunk_keys(D, esize)
    reads = {}
    for b in range(B):
        n = min(max(int(lengths[b]), 0), P * T)
        for i in range(nsplit):
            lo, hi = n * i // nsplit, n * (i + 1) // nsplit
            got = []
            for c0 in range(0, hi - lo, K):
                for r in range(min(K, hi - lo - c0)):
                    pos = lo + c0 + r
                    s = int(pages[b, pos // T])
                    if clip and s >= n_slabs:
                        s = n_slabs - 1
                    if 0 <= s < n_slabs:
                        got.append((pos, s))
            reads[b, i] = got
    return reads


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("D,esize", [(128, 2), (16, 2), (128, 4), (64, 4)])
def test_attend_splits_cover_each_live_key_once(clip, D, esize):
    """Holes (-1) and ids past the pool inside live lengths, a length at a
    page's end, lengths 0, 1, nsplit - 1, nsplit, nsplit + 1 and past P·T:
    the splits read each key below the length whose page resolves exactly
    once, in order, from the slab the plain version reads."""
    T, P, S = 64, 20, 40
    rng = np.random.default_rng(D + esize)
    ns = k_pg.attend_splits(P, T, 9 * 2, 132)
    lengths = np.array([0, 1, ns - 1, ns, ns + 1, 3 * T, 1000, 900, P * T + 50])
    pages = rng.integers(0, S, (len(lengths), P)).astype(np.int32)
    pages[6, 1] = -1  # straddles the boundaries 1000 i / ns
    pages[6, 3] = S + 5  # past the pool
    pages[7, 0] = -1
    reads = replay_attend(pages, lengths, T, S, clip, ns, D, esize)
    for b, n in enumerate(lengths):
        seen = [pos for i in range(ns) for pos, _ in reads[b, i]]
        want = []
        for pos in range(min(int(n), P * T)):
            s = int(pages[b, pos // T])
            s = min(s, S - 1) if clip else s
            if 0 <= s < S:
                want.append(pos)
        assert seen == want
        for i in range(ns):
            assert all(s == min(int(pages[b, p // T]), S - 1) for p, s in reads[b, i])
    for b, n in enumerate(lengths):
        if n >= ns:  # no split is empty once the length reaches nsplit (holes aside)
            assert all(len(reads[b, i]) > 0 for i in range(ns)) or b in (6, 7)


@pytest.mark.parametrize("nsplit", [1, 3, 17, 128])
def test_attend_counters_split_by_page_residue_match_the_plain_twin(nsplit):
    """Split i of (b, h) counts the pages p = i (mod nsplit): every page is
    counted by exactly one block, and the sums are ``ref.attend_counters``."""
    rng = np.random.default_rng(nsplit)
    B, P, T, KH, S = 6, 23, 16, 2, 50
    pages = torch.from_numpy(rng.integers(-1, S + 4, (B, P)).astype(np.int32))
    lengths = torch.tensor([0, 1, 16, 17, 200, 9999], dtype=torch.int32)
    for clip in (True, False):
        v = np.zeros(5, np.int64)
        counted = np.zeros((B, P), np.int64)
        for b in range(B):
            for split in range(nsplit):
                for p in range(split, P, nsplit):
                    counted[b, p] += 1
                    s = int(pages[b, p])
                    s = min(s, S - 1) if clip else s
                    visit = int(0 <= s < S and p * T < int(lengths[b]))
                    kept = min(max(int(lengths[b]) - p * T, 0), T)
                    v += [0, visit, 1 - visit, visit * T, visit * (T - kept)]
        assert (counted == 1).all()
        got = obs_device.pack(pages.device, **{
            "paged_attend.launches": 1, "paged_attend.tiles": KH * v[1],
            "paged_attend.tiles_skipped": KH * v[2], "paged_attend.lanes": KH * v[3],
            "paged_attend.masked_lanes": KH * v[4]})
        assert torch.equal(got, r_pg.attend_counters(pages, lengths, T, KH, S, clip))


@pytest.mark.parametrize("nsplit", [1, 7, 8, 9, 33, 64, k_pg.ATTEND_MAX_SPLITS])
def test_attend_merge_tree_takes_each_split_once_in_order(nsplit):
    """The kernel's merge: split i reports to group i // ATTEND_GROUP, whose
    last block merges the group's splits in order (its ticket counts to the
    group's size); the groups' last merges the groups in order.  Each
    (sequence, head) needs ngroups + 1 tickets, and the wrapper sizes the
    scratch for the splits' and the groups' states."""
    ng = -(-nsplit // k_pg.ATTEND_GROUP)
    sizes = [min(k_pg.ATTEND_GROUP, nsplit - gi * k_pg.ATTEND_GROUP) for gi in range(ng)]
    order = [gi * k_pg.ATTEND_GROUP + j for gi, n in enumerate(sizes) for j in range(n)]
    assert order == list(range(nsplit)) and all(1 <= n <= k_pg.ATTEND_GROUP for n in sizes)
    assert [i // k_pg.ATTEND_GROUP for i in range(nsplit)] == [
        gi for gi, n in enumerate(sizes) for _ in range(n)]
    assert ng <= k_pg.ATTEND_MAX_SPLITS // k_pg.ATTEND_GROUP


def test_attend_buffers_are_made_once_and_grow():
    dev = torch.device("cpu")  # the buffer logic is the same on every device
    tix, part = k_pg.attend_buffers(dev, 3, 10)
    assert tix.numel() >= k_pg.ATTEND_TICKETS0 and tix.dtype == torch.int32 and not tix.any()
    assert part.numel() >= k_pg.ATTEND_PARTS0 and part.dtype == torch.float32
    again = k_pg.attend_buffers(dev, k_pg.ATTEND_TICKETS0, k_pg.ATTEND_PARTS0)
    assert again[0] is tix and again[1] is part
    grown, bigger = k_pg.attend_buffers(dev, tix.numel() + 1, part.numel() + 1)
    assert grown.numel() > tix.numel() and not grown.any() and bigger.numel() > part.numel()
    assert any(t is tix for t in k_pg._attend_retired)
    assert any(t is part for t in k_pg._attend_retired)


def test_attend_buffers_are_not_made_inside_a_graph_capture(monkeypatch):
    """Inside a CUDA-graph capture the tickets' zero fill would only be
    recorded, so making or growing either buffer there raises before
    anything is allocated."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    dev = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="before a CUDA-graph capture"):
        k_pg.attend_buffers(dev, 8, 100)
    assert dev not in k_pg._attend_tickets and dev not in k_pg._attend_parts
