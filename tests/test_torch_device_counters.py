"""Port of the device counter plane (K15, ``repro.obs.device``): the slot
layout, pack / from_block / tape, the zero-sync drain contract, and the
counter vectors of K3, K7, K8/K9, K10/K11 and the slab append held against
the JAX package's on the same seeded numpy inputs (its Pallas kernels in
interpret mode on the CPU).  Mirrors ``tests/obs/test_device_counters.py``.

The vectors are held bitwise, slot for slot, with one stated exception:
four slots count the TPU's tiling in the reference and the card's own lanes
in the port (``repro_torch/obs/device.py``), so there the port must equal
the reference minus the reference's padding term, computed from the
reference's own constants:

* ``push_back.lanes`` and ``push_back.padded_lanes``: rows padded to
  ``DEFAULT_BLOCK_TILE`` and lanes to ``MXU_LANE``;
* ``slab_append.lanes``: lanes padded to ``MXU_LANE``;
* ``paged_gather.masked_tiles``: rows padded to ``DEFAULT_ROW_TILE`` by the
  vmem tiling (the reference's hbm tiling counts exactly the port's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ggarray as ref_gg
from repro.kernels import common as ref_common
from repro.kernels.flatten import ops as ref_fl
from repro.kernels.paged import kernel as ref_pg_kernel
from repro.kernels.paged import ops as ref_pg
from repro.kernels.push_back import kernel as ref_pb_kernel
from repro.kernels.push_back import ops as ref_pb
from repro.obs import device as ref_device
from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.core import indexing
from repro_torch.kernels import common
from repro_torch.kernels.flatten import ops as fl
from repro_torch.kernels.paged import ops as pg
from repro_torch.kernels.push_back import ops as pb
from repro_torch.obs import DeviceCounterPlane, MetricsRegistry, device

IDX = device.SLOT_INDEX


def _t(x) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(x), "cpu")


def _vec(x) -> np.ndarray:
    return tensor_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _pad(n: int, tile: int) -> int:
    return n + (-n) % tile


def _held(port, ref, **minus) -> None:
    """port == ref − minus[slot], bitwise over the float32 vector."""
    want = _vec(ref).copy()
    for slot, pad in minus.items():
        want[IDX[slot.replace("__", ".")]] -= pad
    np.testing.assert_array_equal(_vec(port), want)


def _levels(nblocks, b0, nlev, rng):
    return [rng.standard_normal((nblocks, w)).astype(np.float32)
            for w in indexing.bucket_sizes(b0, nlev)]


# --------------------------------------------------------------------------
# layout + pack + tape + plane
# --------------------------------------------------------------------------

def test_slot_layout_is_the_reference_layout():
    assert device.SLOTS == ref_device.SLOTS
    assert device.NSLOTS == len(device.SLOTS) == len(set(device.SLOTS))
    assert device.SLOT_INDEX == ref_device.SLOT_INDEX
    assert device.new_block("cpu").dtype == torch.int32
    assert tuple(device.new_block("cpu").shape) == (device.NSLOTS,)


def test_pack_and_from_block_round_trip():
    vec = device.pack("cpu", **{"push_back.waves": 3, "paged_attend.masked_lanes": 7})
    d = device.as_dict(vec)
    assert d["push_back.waves"] == 3.0 and d["paged_attend.masked_lanes"] == 7.0
    assert sum(d.values()) == 10.0  # unnamed slots stay zero
    # device scalars and Python numbers mix; the cached host part is not aliased
    again = device.pack(**{"push_back.waves": 3, "flatten.span_rows": torch.tensor(5)})
    again += 1
    assert device.as_dict(device.pack("cpu", **{"push_back.waves": 3}))["push_back.waves"] == 3.0
    assert device.as_dict(again)["flatten.span_rows"] == 6.0
    blk = device.new_block("cpu")
    blk[IDX["flatten.rows_touched"]] = 11
    vec = device.from_block(blk)
    assert vec.dtype == torch.float32 and device.as_dict(vec)["flatten.rows_touched"] == 11.0
    np.testing.assert_array_equal(
        _vec(device.pack("cpu", **{"slab_append.lanes": 9, "push_back.level_writes": 4})),
        np.asarray(ref_device.pack(**{"slab_append.lanes": 9, "push_back.level_writes": 4})))


def test_record_is_noop_without_a_tape_and_tapes_nest():
    device.record(device.pack("cpu", **{"push_back.waves": 99}))  # must not raise
    assert not device.recording()
    with device.tape() as outer:
        device.record(device.pack("cpu", **{"push_back.waves": 1}))
        with device.tape() as inner:
            assert device.recording()
            device.record(device.pack("cpu", **{"push_back.waves": 10}))
        device.record(device.pack("cpu", **{"push_back.waves": 2}))
    assert not device.recording()
    assert device.as_dict(outer.total())["push_back.waves"] == 3.0
    assert device.as_dict(inner.total())["push_back.waves"] == 10.0
    with device.tape() as t:
        pass
    assert sum(device.as_dict(t.total("cpu")).values()) == 0.0


def test_plane_reads_nothing_until_counters(monkeypatch):
    """add() and flush() stay on the device; counters() is the drain point."""
    reg = MetricsRegistry()
    plane = DeviceCounterPlane(reg)
    vecs = [device.pack("cpu", **{"slab_append.waves": 1, "slab_append.lanes": 4,
                                  "slab_append.active_lanes": torch.tensor(3)})
            for _ in range(2)]
    reads = []
    for name in ("item", "cpu", "tolist", "numpy"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _r=real, _n=name, **k: reads.append(_n) or _r(self, *a, **k))
    for v in vecs:
        plane.add(v)
    assert plane.pending == 2 and reads == [], "add() must be a list append"
    plane.flush()
    assert plane.pending == 0 and reads == [], "flush() hands device scalars to add_lazy"
    got = plane.counters()
    assert reads, "counters() is the drain point"
    assert got["slab_append.waves"] == 2.0 and got["slab_append.lanes"] == 8.0
    assert got["slab_append.active_lanes"] == 6.0
    assert reg.counter("device.slab_append.waves").total() == 2.0


# --------------------------------------------------------------------------
# K3 — push-back: one group, two groups, empty waves
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ngroups", [1, 2])
@pytest.mark.parametrize("nblocks,b0,nlev,m,p_live", [
    (5, 2, 2, 11, 0.6),   # the reference test's shape
    (9, 3, 4, 130, 0.5),  # rows and lanes past one tile, writes across levels
    (4, 2, 3, 1, 1.0),    # the decode wave (m = 1)
    (3, 4, 2, 6, 0.0),    # a wave with no live lane
])
def test_push_back_counters_match_reference(ngroups, nblocks, b0, nlev, m, p_live):
    rng = np.random.default_rng(3 + m)
    cap = indexing.capacity(b0, nlev)
    levels = _levels(nblocks, b0, nlev, rng)
    elems = rng.standard_normal((nblocks, m)).astype(np.float32)
    mask = rng.random((nblocks, m)) < p_live
    sizes = rng.integers(0, cap - 2, nblocks).astype(np.int32)
    rgroups = tuple(tuple(jnp.asarray(lv) for lv in levels) for _ in range(ngroups))
    ref = ref_pb.push_back_fused_multi(rgroups, jnp.asarray(sizes), b0,
                                       (jnp.asarray(elems),) * ngroups, jnp.asarray(mask),
                                       instrument=True)
    oracle = ref_pb.push_back_fused_multi(rgroups, jnp.asarray(sizes), b0,
                                          (jnp.asarray(elems),) * ngroups, jnp.asarray(mask),
                                          use_ref=True, instrument=True)
    np.testing.assert_array_equal(np.asarray(ref[3]), np.asarray(oracle[3]))
    pad = (_pad(nblocks, ref_pb_kernel.DEFAULT_BLOCK_TILE) * _pad(m, ref_common.MXU_LANE)
           - nblocks * m)
    assert ref_device.as_dict(ref[3])["push_back.padded_lanes"] == pad

    def run(instrument):
        groups = tuple(tuple(_t(lv) for lv in levels) for _ in range(ngroups))
        return pb.push_back_fused_multi(groups, _t(sizes), b0, (_t(elems),) * ngroups,
                                        _t(mask), instrument=instrument)

    ours, plain = run(True), run(False)
    _held(ours[3], ref[3], push_back__lanes=pad, push_back__padded_lanes=pad)
    d = device.as_dict(ours[3])
    assert d["push_back.lanes"] == nblocks * m and d["push_back.padded_lanes"] == 0
    assert d["push_back.active_lanes"] == float(mask.sum())
    # the data outputs are the same with and without counters
    for ga, gb in zip(ours[0], plain[0]):
        for a, b in zip(ga, gb):
            assert torch.equal(a, b)
    assert torch.equal(ours[1], plain[1]) and torch.equal(ours[2], plain[2])
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))


def test_push_back_empty_wave_counts_nothing():
    arr = ref_gg.init(3, 2, nbuckets=1)
    ref = ref_pb.push_back_fused_multi((arr.buckets,), jnp.zeros((3,), jnp.int32), 2,
                                       (jnp.zeros((3, 0), jnp.float32),), jnp.zeros((3, 0), bool),
                                       instrument=True)
    levels = (torch.zeros((3, 2)),)
    ours = pb.push_back_fused(levels, torch.zeros(3, dtype=torch.int32), 2,
                              torch.zeros((3, 0)), torch.zeros((3, 0), dtype=torch.bool),
                              instrument=True)
    assert len(ours) == 4
    _held(ours[3], ref[3])
    assert sum(device.as_dict(ours[3]).values()) == 0.0


# --------------------------------------------------------------------------
# K7 — segmented gather (rows touched, including empty blocks and the tail)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nblocks,b0,nlev,empty_every", [
    (5, 2, 1, 0),     # the reference test's shape
    (7, 3, 5, 2),     # nblocks·cap = 651: a ragged tail tile, empty blocks
    (40, 4, 4, 3),    # 2400 elements: ten tiles, one ragged
    (3, 128, 2, 1),   # every block empty
])
def test_flatten_counters_match_reference(nblocks, b0, nlev, empty_every):
    rng = np.random.default_rng(6 + nblocks)
    cap = indexing.capacity(b0, nlev)
    levels = _levels(nblocks, b0, nlev, rng)
    sizes = rng.integers(0, cap + 1, nblocks).astype(np.int32)
    if empty_every:
        sizes[::empty_every] = 0
    ref_out, ref_vec = ref_fl.flatten_segmented(tuple(jnp.asarray(lv) for lv in levels),
                                                jnp.asarray(sizes), b0, instrument=True)
    levels_t = tuple(_t(lv) for lv in levels)
    out, vec = fl.flatten_segmented(levels_t, _t(sizes), b0, instrument=True)
    _held(vec, ref_vec)
    assert torch.equal(out, fl.flatten_segmented(levels_t, _t(sizes), b0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    d = device.as_dict(vec)
    assert d["flatten.launches"] == 1.0 and d["flatten.span_rows"] == float(sizes.sum())
    out2, vec2 = fl.flatten(levels_t, _t(sizes), b0, instrument=True)
    assert torch.equal(out2, out) and torch.equal(vec2, vec)


def test_flatten_dispatch_reports_the_span():
    rng = np.random.default_rng(60)
    levels = _levels(4, 2, 2, rng)
    sizes = np.asarray([3, 0, 6, 1], np.int32)
    ref_out, ref_vec = ref_fl.flatten(tuple(jnp.asarray(lv) for lv in levels), jnp.asarray(sizes),
                                      2, impl="dispatch", instrument=True)
    out, vec = fl.flatten(tuple(_t(lv) for lv in levels), _t(sizes), 2, impl="dispatch",
                          instrument=True)
    _held(vec, ref_vec)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))


# --------------------------------------------------------------------------
# K8/K9 — paged gather; K10/K11 — paged attention; K12 — slab append
# --------------------------------------------------------------------------

def _fleet(rng, S, N, P, npages):
    pages = np.full((N, P), -1, np.int32)
    perm = rng.permutation(S)
    k = 0
    for i, c in enumerate(npages):
        for p in range(c):
            pages[i, p] = perm[k]
            k += 1
    return pages


def _extents(x, cuts):
    return tuple(np.split(x, cuts))


@pytest.mark.parametrize("layout", ["flat", "extents"])
def test_paged_gather_counters_match_reference(layout):
    rng = np.random.default_rng(4)
    S, T, N, P = 11, 4, 5, 3
    pool = rng.standard_normal((S, T, 3)).astype(np.float32)
    pages = _fleet(rng, S, N, P, [3, 0, 2, 1, 3])
    pages[1, 1] = S + 2  # past the pool: clipped (flat) or dead (extents)
    parts = (pool,) if layout == "flat" else _extents(pool, [4, 9])
    rpool = jnp.asarray(pool) if layout == "flat" else tuple(jnp.asarray(p) for p in parts)
    tpool = _t(pool) if layout == "flat" else tuple(_t(p) for p in parts)
    ref_out, ref_vec = ref_pg.paged_gather(rpool, jnp.asarray(pages), instrument=True)
    _, hbm_vec = ref_pg.paged_gather(rpool, jnp.asarray(pages), memory_space="hbm",
                                     instrument=True)
    out, vec = pg.paged_gather(tpool, _t(pages), instrument=True)
    pad = (_pad(N, ref_pg_kernel.DEFAULT_ROW_TILE) - N) * P
    _held(vec, ref_vec, paged_gather__masked_tiles=pad)
    _held(vec, hbm_vec)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    assert torch.equal(out, pg.paged_gather(tpool, _t(pages)))


@pytest.mark.parametrize("layout", ["flat", "extents"])
def test_paged_attend_counters_match_reference(layout):
    rng = np.random.default_rng(5)
    S, T, N, P, KH, G, D = 13, 4, 5, 3, 2, 3, 8
    pages = _fleet(rng, S, N, P, [3, 1, 2, 1, 3])
    kp = rng.standard_normal((S, T, KH, D)).astype(np.float32)
    vp = rng.standard_normal((S, T, KH, D)).astype(np.float32)
    q = rng.standard_normal((N, KH, G, D)).astype(np.float32)
    lengths = np.asarray([9, 2, 8, 1, 12], np.int32)
    if layout == "flat":
        rk, rv, tk, tv = jnp.asarray(kp), jnp.asarray(vp), _t(kp), _t(vp)
    else:
        rk = tuple(jnp.asarray(p) for p in _extents(kp, [5]))
        rv = tuple(jnp.asarray(p) for p in _extents(vp, [5]))
        tk, tv = tuple(_t(p) for p in _extents(kp, [5])), tuple(_t(p) for p in _extents(vp, [5]))
    _, ref_vec = ref_pg.paged_attend(jnp.asarray(q), rk, rv, jnp.asarray(pages),
                                     jnp.asarray(lengths), instrument=True)
    out, vec = pg.paged_attend(_t(q), tk, tv, _t(pages), _t(lengths), instrument=True)
    _held(vec, ref_vec)
    assert torch.equal(out, pg.paged_attend(_t(q), tk, tv, _t(pages), _t(lengths)))
    d = device.as_dict(vec)
    assert d["paged_attend.lanes"] == d["paged_attend.tiles"] * T
    assert 0 < d["paged_attend.masked_lanes"] < d["paged_attend.lanes"]
    assert d["paged_attend.tiles_skipped"] > 0


def test_slab_append_counters_match_reference():
    rng = np.random.default_rng(7)
    S, T, N, P, m = 14, 4, 4, 4, 3
    pages = _fleet(rng, S, N, P, [4, 2, 3, 4])
    owners = np.full((S,), -1, np.int32)
    bases = np.zeros((S,), np.int32)
    for i in range(N):
        for p in range(P):
            if pages[i, p] >= 0:
                owners[pages[i, p]], bases[pages[i, p]] = i, p * T
    sizes = np.asarray([7, 1, 5, 10], np.int32)
    pool = rng.standard_normal((S, T)).astype(np.float32)
    elems = rng.standard_normal((N, m)).astype(np.float32)
    mask = rng.random((N, m)) > 0.4
    ref = ref_pg.slab_append(jnp.asarray(pool), jnp.asarray(owners), jnp.asarray(bases),
                             jnp.asarray(sizes), jnp.asarray(elems), jnp.asarray(mask),
                             instrument=True)
    args = (_t(owners), _t(bases), _t(sizes), _t(elems), _t(mask))
    ours = pg.slab_append(_t(pool), *args, instrument=True)
    plain = pg.slab_append(_t(pool), *args)
    assert len(ours) == 4 and len(plain) == 3
    _held(ours[3], ref[3], slab_append__lanes=N * (_pad(m, ref_common.MXU_LANE) - m))
    assert torch.equal(ours[0], plain[0]) and torch.equal(ours[2], plain[2])
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    assert common.launch_counts()["counter_plane"] == 0  # CPU: plain versions only
