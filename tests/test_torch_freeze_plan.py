"""The plans of the freeze's two kernels, replayed on the CPU: K2, the
tensor-core row scan (``kernels/scan_mxu/kernel.py``, ``csrc/scan_mxu.cu``:
a chained single pass over 16 × TILE_COLS tiles taken by ticket), and K7,
the segmented gather (``kernels/flatten/kernel.py``, ``csrc/flatten.cu``: a
block per RANGE_BYTES of output walking its owners, from the plane or
straight from the bucket levels).  The kernels run only on a card; these
tests replay what their blocks compute in numpy on seeded inputs and hold
it against the plain versions (``ref.py``) and the JAX package: K2's tiles
each taken by one ticket and its chain, completed in shuffled orders,
bitwise ``torch.cumsum`` with every status word left zero; K7's pieces
covering each output element once and reproducing ``ref.gather_global``,
its per-block counts summing to the reference's oracle, its live pieces
splitting at the level boundaries B0·(2^b − 1); and the levels form's plain
version bitwise equal to ``repro.kernels.flatten.ops.flatten_segmented``
(Pallas interpret mode).  Tolerance: none — all of it is integer
arithmetic or moves bits."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flatten import ops as ref_ops
from repro_torch import convert
from repro_torch.core import indexing
from repro_torch.kernels.flatten import kernel as k_fl
from repro_torch.kernels.flatten import ops as fl_ops
from repro_torch.kernels.flatten import ref as r_fl
from repro_torch.kernels.scan_mxu import kernel as k_sm
from repro_torch.obs import device as obs_device

W = k_sm.TILE_COLS


# ---------------------------------------------------------------------------
# K2: tiles, tickets, the chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols,groups,tiles", [
    (1, 1, 1, 1), (16, W, 1, 1), (17, W, 2, 1), (16, W + 1, 1, 2), (33, 3 * W + 5, 3, 4),
    (512, 262_144, 32, 262_144 // W),  # the main path's last grow wave
])
def test_scan_plan(rows, cols, groups, tiles):
    plan = k_sm.scan_plan(rows, cols)
    assert (plan.groups, plan.tiles) == (groups, tiles)
    # a status word per row of every boundary between two tiles; none where a row group is one tile
    assert plan.status_words == groups * (tiles - 1) * k_sm.TILE_ROWS


@pytest.mark.parametrize("rows,cols", [(1, 1), (17, 5 * W + 7), (512, 262_144), (100, 2 * W)])
def test_every_tile_takes_one_ticket_after_its_predecessor(rows, cols):
    plan = k_sm.scan_plan(rows, cols)
    tiles = [k_sm.ticket_tile(t, plan.groups) for t in range(plan.groups * plan.tiles)]
    assert sorted(tiles) == [(g, c) for g in range(plan.groups) for c in range(plan.tiles)]
    ticket = {tile: t for t, tile in enumerate(tiles)}
    for (g, c), t in ticket.items():
        if c > 0:  # the predecessor in its rows took an earlier ticket: no wait on an unscheduled block
            assert ticket[g, c - 1] == t - plan.groups


def _scan_input(rng, kind, shape):
    if kind == "mask":
        return (rng.random(shape) < 0.5).astype(np.int32)
    if kind == "full":  # wrap-around
        return rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, shape,
                            dtype=np.int64).astype(np.int32)
    return rng.integers(-300, 300, shape).astype(np.int32)


@pytest.mark.parametrize("kind", ["mask", "full", "small"])
@pytest.mark.parametrize("rows,cols", [
    (1, 1), (1, 31), (17, 32), (17, 33), (17, W - 1), (17, W), (17, W + 1), (5, 3 * W), (33, 2 * W + 3),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_chain_in_shuffled_order_is_cumsum_and_leaves_buffers_zero(kind, rows, cols, seed):
    rng = np.random.default_rng([rows, cols, seed, len(kind)])
    x = _scan_input(rng, kind, (rows, cols))
    plan = k_sm.scan_plan(rows, cols)
    order = rng.permutation(plan.groups * plan.tiles)
    out, status, counter = k_sm.chain_replay(x, order)
    want = torch.cumsum(torch.from_numpy(x), 1, dtype=torch.int32).numpy()
    np.testing.assert_array_equal(out, want)
    assert status.shape == (plan.status_words,) and not status.any()
    assert counter == 0


def test_chain_in_reverse_order_waits_and_still_completes():
    """Tiles finishing last-first: every tile but a row's first waits."""
    rng = np.random.default_rng(7)
    x = _scan_input(rng, "full", (40, 4 * W + 1))
    plan = k_sm.scan_plan(*x.shape)
    out, status, counter = k_sm.chain_replay(x, np.arange(plan.groups * plan.tiles)[::-1])
    np.testing.assert_array_equal(out, torch.cumsum(torch.from_numpy(x), 1, dtype=torch.int32).numpy())
    assert not status.any() and counter == 0


# ---------------------------------------------------------------------------
# K7: ranges, pieces, counters, level runs
# ---------------------------------------------------------------------------

def _tables(rng, n, cap, *, empty_every=0, gaps=False, over=False):
    sizes = rng.integers(0, cap + 1, n)
    if empty_every:
        sizes[::empty_every] = 0
    if over:  # live items past cap: clamped to the row's last item
        sizes[::2] += cap // 2 + 1
    starts = np.cumsum(sizes) - sizes
    live = rng.integers(0, sizes + 1) if gaps else sizes
    return starts.astype(np.int32), (starts + live).astype(np.int32)


CASES = [  # (nblocks, b0, nlevels, esize, table options)
    (300, 2, 4, 4, {"empty_every": 7}),  # many owners a range
    (300, 2, 4, 2, {"empty_every": 7, "gaps": True}),
    (12, 512, 4, 4, {"empty_every": 3}),  # several ranges an owner
    (9, 512, 4, 2, {"empty_every": 2, "gaps": True}),
    (5, 3, 3, 4, {}),  # a ragged tail
    (1000, 1, 1, 4, {"empty_every": 2}),  # cap = 1
    (3, 3, 3, 4, {"over": True}),
    (64, 1024, 5, 4, {"gaps": True}),  # owner starts anywhere
    (40, 64, 6, 2, {"empty_every": 5}),
]


def _render(pieces, levels, b0, cap, n_out, dtype):
    """Apply a launch's pieces as its blocks write them → (output, writes
    per element).  Copy pieces read the levels run by run."""
    out = np.zeros(n_out, dtype)
    hits = np.zeros(n_out, np.int64)
    for block in pieces:
        for p in block:
            hits[p.a:p.b] += 1
            if p.kind == "copy":
                runs = k_fl.level_runs(p.off, p.b - p.a, b0)
                out[p.a:p.b] = np.concatenate([levels[b][p.owner, li:li + n] for b, li, n in runs])
            elif p.kind == "clamp":
                last = len(levels) - 1
                out[p.a:p.b] = levels[last][p.owner, -1]
            else:
                out[p.a:p.b] = 0
    return out, hits


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_pieces_cover_once_and_match_the_plain_gather(case, seed):
    nblocks, b0, nlev, esize, opts = CASES[case]
    rng = np.random.default_rng([case, seed])
    cap = indexing.capacity(b0, nlev)
    starts, ends = _tables(rng, nblocks, cap, **opts)
    dtype = np.float32 if esize == 4 else np.float16
    levels = [rng.standard_normal((nblocks, w)).astype(dtype) for w in indexing.bucket_sizes(b0, nlev)]
    pieces = k_fl.gather_pieces(starts, ends, nblocks, cap, esize)
    assert len(pieces) == -(-nblocks * cap // (k_fl.RANGE_BYTES // esize))
    out, hits = _render(pieces, levels, b0, cap, nblocks * cap, dtype)
    assert np.all(hits == 1), "an output element is written by no piece or by two"
    plane = torch.from_numpy(np.concatenate(levels, axis=1))
    want = r_fl.gather_global(plane, torch.from_numpy(starts), torch.from_numpy(ends)).numpy()
    np.testing.assert_array_equal(out.view(np.uint16 if esize == 2 else np.uint32),
                                  want.view(np.uint16 if esize == 2 else np.uint32))
    # the kinds fall where the plain gather puts them: copies inside an owner's live items,
    # zeros in the gaps and the tail
    for block in pieces:
        for p in block:
            if p.kind == "zero":
                assert not np.any(want[p.a:p.b])


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("seed", [0, 1])
def test_range_rows_sum_to_the_reference_oracle(case, seed):
    nblocks, b0, nlev, esize, opts = CASES[case]
    rng = np.random.default_rng([case, seed, 9])
    cap = indexing.capacity(b0, nlev)
    starts, ends = _tables(rng, nblocks, cap, **opts)
    rows = k_fl.range_rows(starts, nblocks, cap, esize)
    # per range: the oracle's per-tile hi - lo summed over the range's tiles
    st = starts.astype(np.int64)
    t0 = np.arange(0, nblocks * cap, r_fl.SEG_TILE)
    per_tile = (np.searchsorted(st, t0 + r_fl.SEG_TILE - 1, side="right")
                - np.maximum(np.searchsorted(st, t0, side="right") - 1, 0))
    tiles_a_range = k_fl.RANGE_BYTES // esize // r_fl.SEG_TILE
    want = np.add.reduceat(per_tile, np.arange(0, len(per_tile), tiles_a_range))
    np.testing.assert_array_equal(rows, want)
    vec = r_fl.gather_counters(torch.from_numpy(starts), torch.from_numpy(ends), nblocks, cap)
    jax_vec = np.asarray(ref_ops._seg_ctr_oracle(jnp.asarray(starts), jnp.asarray(ends), nblocks, cap))
    np.testing.assert_array_equal(vec.numpy(), jax_vec)
    assert rows.sum() == vec[obs_device.SLOT_INDEX["flatten.rows_touched"]]


def test_range_rows_with_starts_at_range_and_tile_edges():
    """Empty blocks whose start is a range's or a tile's first element add
    nothing; one inside a tile adds one."""
    rng_elems = k_fl.RANGE_BYTES // 4
    cap = 3 * rng_elems
    sizes = np.asarray([rng_elems, 0, 0, 256, 0, 100, rng_elems - 356, 0], np.int64)
    starts = (np.cumsum(sizes) - sizes).astype(np.int32)
    rows = k_fl.range_rows(starts, len(sizes), cap, 4)
    ntiles = -(-len(sizes) * cap // r_fl.SEG_TILE)
    assert rows.sum() == ntiles + 1  # only the start at rng_elems + 356 lies inside a tile
    vec = r_fl.gather_counters(torch.from_numpy(starts), torch.from_numpy(starts), len(sizes), cap)
    assert rows.sum() == vec[obs_device.SLOT_INDEX["flatten.rows_touched"]]


@pytest.mark.parametrize("b0,nlev", [(1, 1), (2, 4), (3, 5), (2048, 8)])
def test_level_runs_split_at_level_boundaries(b0, nlev):
    cap = indexing.capacity(b0, nlev)
    bounds = {b0 * ((1 << b) - 1) for b in range(nlev + 1)}
    rng = np.random.default_rng(b0 + nlev)
    for a, b in [(0, cap), (cap - 1, cap)] + [sorted(rng.integers(0, cap + 1, 2)) for _ in range(20)]:
        off, n = int(a), int(b - a)
        runs = k_fl.level_runs(off, n, b0)
        assert sum(r[2] for r in runs) == n
        x = off
        for b, li, length in runs:
            first = b0 * ((1 << b) - 1)
            assert first + li == x and 0 <= li and li + length <= b0 << b  # inside one level
            x += length
            assert x in bounds or x == off + n  # a run ends at a level's end or the piece's


# ---------------------------------------------------------------------------
# the levels form's plain version against the JAX package
# ---------------------------------------------------------------------------

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "i32": (jnp.int32, torch.int32)}


def _bits(x) -> np.ndarray:
    a = convert.tensor_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("dtype_key", sorted(DTYPES))
@pytest.mark.parametrize("nblocks,b0,nlev,empty_every", [(7, 3, 4, 2), (13, 1, 5, 3), (4, 8, 2, 1), (9, 2, 6, 4)])
def test_plain_levels_freeze_matches_the_reference(dtype_key, nblocks, b0, nlev, empty_every):
    jdtype, _ = DTYPES[dtype_key]
    rng = np.random.default_rng([nblocks, b0, nlev, empty_every])
    cap = indexing.capacity(b0, nlev)
    sizes = rng.integers(0, cap + 1, nblocks).astype(np.int32)
    sizes[::empty_every] = 0
    jlevels = tuple(jnp.asarray(rng.integers(-1000, 1000, (nblocks, w)) if dtype_key == "i32"
                                else rng.standard_normal((nblocks, w)), jdtype)
                    for w in indexing.bucket_sizes(b0, nlev))
    levels = tuple(convert.tensor_from_numpy(np.asarray(lv), "cpu") for lv in jlevels)
    want, want_vec = ref_ops.flatten_segmented(jlevels, jnp.asarray(sizes), b0, instrument=True)
    starts = indexing.block_starts(torch.from_numpy(sizes))
    got = r_fl.gather_levels(levels, b0, starts, starts + torch.from_numpy(sizes))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    out, vec = fl_ops.flatten_segmented(levels, torch.from_numpy(sizes), b0, instrument=True)
    np.testing.assert_array_equal(_bits(out), _bits(want))
    np.testing.assert_array_equal(vec.numpy(), np.asarray(want_vec))
