"""Port of ``repro.core.ggarray``, held against the JAX package on the CPU:
the GGArray functions bitwise, the capacity planner's host-sync and growth
counts exactly, and a JAX-grown array carried into the port through
``repro_torch.convert``.  Tolerance: none anywhere (data movement and
integer counts), except ``map_elements``, whose user function adds 10.0 in
float32 in both packages — the same single rounding, so also exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ggarray as ref_gg
from repro_torch import convert
from repro_torch.core import ggarray as gg


def _bits(x) -> np.ndarray:
    a = convert.tensor_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_same(ours: gg.GGArray, ref: ref_gg.GGArray):
    assert ours.nbuckets == ref.nbuckets and ours.b0 == ref.b0
    for a, b in zip(ours.buckets, ref.buckets):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(ours.sizes.numpy(), np.asarray(ref.sizes))


def _grown_pair(nblocks=4, b0=2, waves=(3, 6, 1, 9), seed=0, method="auto"):
    rng = np.random.default_rng(seed)
    ref = ref_gg.init(nblocks, b0)
    ours = gg.init(nblocks, b0, device="cpu")
    for m in waves:
        elems = rng.standard_normal((nblocks, m)).astype(np.float32)
        mask = rng.random((nblocks, m)) < 0.7
        ref = ref_gg.ensure_capacity(ref, m)
        ours = gg.ensure_capacity(ours, m)
        ref, _ = ref_gg.push_back(ref, jnp.asarray(elems), jnp.asarray(mask), method=method)
        ours, _ = gg.push_back(ours, torch.from_numpy(elems), torch.from_numpy(mask), method=method)
    return ours, ref


@pytest.mark.parametrize("method", ["atomic", "auto", "fused", "mxu", "scan", "tile"])
def test_push_back_every_method_matches_reference(method):
    ours, ref = _grown_pair(method=method, waves=(3, 6, 40, 1))
    _assert_same(ours, ref)
    assert gg.PUSH_BACK_METHODS == ref_gg.PUSH_BACK_METHODS


def test_push_back_leaves_its_input_untouched_and_append_writes_in_place():
    arr = gg.init(2, 2, nbuckets=2, device="cpu")
    before = [b.clone() for b in arr.buckets]
    out, _ = gg.push_back(arr, torch.ones((2, 3)))
    for a, b in zip(arr.buckets, before):
        assert torch.equal(a, b)
    assert int(arr.sizes.sum()) == 0 and int(out.sizes.sum()) == 6
    new, _, headroom = gg.append(arr, torch.ones((2, 3)), method="fused")
    for a, b in zip(new.buckets, arr.buckets):
        assert a is b  # same storage: written in place
    assert int(headroom) == new.capacity_per_block - 3


@pytest.mark.parametrize("method", ["scan", "fused"])
def test_append_headroom_matches_reference(method):
    ours = gg.init(2, 4, nbuckets=1, device="cpu")
    ref = ref_gg.init(2, 4, nbuckets=1)
    for m in (3, 2):
        ours, pos_o, hd_o = gg.append(ours, torch.ones((2, m)), method=method)
        ref, pos_r, hd_r = ref_gg.append(ref, jnp.ones((2, m)), method=method)
        np.testing.assert_array_equal(pos_o.numpy(), np.asarray(pos_r))
        assert hd_o.dtype == torch.int32 and int(hd_o) == int(hd_r)
    assert int(hd_o) == -1, "negative headroom must signal dropped writes"


def test_grow_is_copy_free_and_reserve_matches_reference():
    arr = gg.init(2, 2, nbuckets=1, device="cpu")
    arr, _ = gg.push_back(arr, torch.tensor([[1.0, 2.0], [3.0, 4.0]]))
    grown = gg.grow(arr, 2)
    for a, b in zip(arr.buckets, grown.buckets):
        assert a is b
    ref = ref_gg.init(2, 2, nbuckets=1)
    ref, _ = ref_gg.push_back(ref, jnp.asarray([[1.0, 2.0], [3.0, 4.0]]))
    for n in (0, 1, 5, 30):
        assert gg.ensure_capacity(arr, n).nbuckets == ref_gg.ensure_capacity(ref, n).nbuckets
        assert gg.reserve(arr, n, max_size=2).nbuckets == ref_gg.reserve(ref, n, max_size=2).nbuckets
        assert bool(gg.needs_grow(arr, n)) == bool(ref_gg.needs_grow(ref, n))


def test_read_write_gather_match_reference():
    ours, ref = _grown_pair(nblocks=5, b0=2, waves=(4, 7, 2), seed=3)
    n = int(ours.sizes.sum())
    idx = np.arange(n, dtype=np.int32)[::-1].copy()
    np.testing.assert_array_equal(_bits(gg.read_global(ours, torch.from_numpy(idx))),
                                  _bits(ref_gg.read_global(ref, jnp.asarray(idx))))
    vals = (np.arange(n, dtype=np.float32) * 2.5)
    w_ours = gg.write_global(ours, torch.from_numpy(idx), torch.from_numpy(vals))
    w_ref = ref_gg.write_global(ref, jnp.asarray(idx), jnp.asarray(vals))
    _assert_same(w_ours, w_ref)
    _assert_same(ours, ref)  # write_global returns a new array
    blocks = np.repeat(np.arange(5, dtype=np.int32)[:, None], 3, axis=1)
    pos = np.tile(np.arange(3, dtype=np.int32), (5, 1))
    np.testing.assert_array_equal(_bits(gg.gather_block(ours, torch.from_numpy(blocks), torch.from_numpy(pos))),
                                  _bits(ref_gg.gather_block(ref, jnp.asarray(blocks), jnp.asarray(pos))))


def test_map_elements_flatten_total_match_reference():
    ours, ref = _grown_pair(seed=4)
    m_ours = gg.map_elements(ours, lambda x: x + 10.0)
    m_ref = ref_gg.map_elements(ref, lambda x: x + 10.0)
    _assert_same(m_ours, m_ref)
    flat_o, tot_o = gg.flatten(m_ours)
    flat_r, tot_r = ref_gg.flatten(m_ref)
    np.testing.assert_array_equal(_bits(flat_o), _bits(flat_r))
    assert int(tot_o) == int(tot_r) == int(gg.total_size(ours)) == int(ref_gg.total_size(ref))
    assert gg.memory_elems(ours) == ref_gg.memory_elems(ref)
    np.testing.assert_array_equal(gg.block_starts(ours).numpy(), np.asarray(ref_gg.block_starts(ref)))


def test_item_shape_payloads_match_reference():
    rng = np.random.default_rng(1)
    elems = jnp.asarray(rng.standard_normal((2, 3, 3, 4)), jnp.bfloat16)
    ref, _ = ref_gg.push_back(ref_gg.init(2, 2, item_shape=(3, 4), dtype=jnp.bfloat16, nbuckets=2), elems)
    ours, _ = gg.push_back(gg.init(2, 2, item_shape=(3, 4), dtype=torch.bfloat16, nbuckets=2, device="cpu"),
                           convert.tensor_from_numpy(np.asarray(elems), "cpu"))
    _assert_same(ours, ref)
    flat_o, _ = gg.flatten(ours)
    flat_r, _ = ref_gg.flatten(ref)
    assert tuple(flat_o.shape) == flat_r.shape
    np.testing.assert_array_equal(_bits(flat_o), _bits(flat_r))


@pytest.mark.parametrize("n,nblocks,b0", [(37, 4, 2), (0, 3, 2), (64, 8, 8)])
def test_from_flat_matches_reference(n, nblocks, b0):
    flat = np.random.default_rng(n).standard_normal(max(n, 1) + 5).astype(np.float32)
    ours = gg.from_flat(torch.from_numpy(flat), n, nblocks=nblocks, b0=b0)
    ref = ref_gg.from_flat(jnp.asarray(flat), n, nblocks=nblocks, b0=b0)
    _assert_same(ours, ref)


def test_push_back_rejects_float_mask_and_bad_shape():
    arr = gg.init(2, 2, nbuckets=2, device="cpu")
    with pytest.raises(TypeError):
        gg.push_back(arr, torch.ones((2, 2)), torch.ones((2, 2)))
    with pytest.raises(ValueError):
        gg.push_back(arr, torch.ones((3, 2)))


# --------------------------------------------------------------------------
# The capacity planner: the same host syncs and growth events as the reference.
# --------------------------------------------------------------------------

def _planner_run(pkg, arr, waves, host_mask):
    planner = pkg.CapacityPlanner()
    for m, mask in waves:
        planner_mask = mask if host_mask else (
            torch.from_numpy(mask) if pkg is gg else jnp.asarray(mask))
        arr = planner.reserve(arr, m, mask=planner_mask)
        dev_mask = torch.from_numpy(mask) if pkg is gg else jnp.asarray(mask)
        ones = torch.ones((mask.shape[0], m)) if pkg is gg else jnp.ones((mask.shape[0], m))
        arr, _, hd = pkg.append(arr, ones, dev_mask)
        planner.note_append(arr, hd)
    return arr, planner


def _waves(kind, nwaves=24, nblocks=4):
    rng = np.random.default_rng(11)
    out = []
    for w in range(nwaves):
        m = int(rng.integers(1, 12))
        if kind == "dense":
            mask = np.ones((nblocks, m), bool)
        elif kind == "skew":
            mask = np.zeros((nblocks, m), bool)
            mask[w % 2] = rng.random(m) < 0.9
        else:
            mask = rng.random((nblocks, m)) < 0.3
        out.append((m, mask))
    return out


@pytest.mark.parametrize("kind", ["dense", "skew", "sparse"])
@pytest.mark.parametrize("host_mask", [True, False], ids=["numpy-mask", "device-mask"])
def test_planner_counts_match_reference(kind, host_mask):
    waves = _waves(kind)
    ours, p_ours = _planner_run(gg, gg.init(4, 2, device="cpu"), waves, host_mask)
    ref, p_ref = _planner_run(ref_gg, ref_gg.init(4, 2), waves, host_mask)
    assert p_ours.host_syncs == p_ref.host_syncs
    assert p_ours.grow_events == p_ref.grow_events
    assert p_ours.metrics() == p_ref.metrics()
    _assert_same(ours, ref)


def test_planner_for_array_seeds_with_one_read():
    ours, ref = _grown_pair()
    p_ours, p_ref = gg.CapacityPlanner.for_array(ours), ref_gg.CapacityPlanner.for_array(ref)
    assert p_ours.host_syncs == p_ref.host_syncs == 1
    assert p_ours.size_ub == p_ref.size_ub


def test_steady_state_append_reads_nothing_from_the_device(monkeypatch):
    """Planner + in-place append: the steady state makes no host read (no
    ``Tensor.item``/``cpu``/``tolist``/``numpy`` and no planner sync)."""
    arr = gg.init(4, 8, nbuckets=4, device="cpu")  # capacity 120/block
    planner = gg.CapacityPlanner()
    elems = torch.ones((4, 5))
    calls = []
    for name in ("item", "cpu", "tolist", "numpy", "__int__", "__bool__", "__float__"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _r=real, _n=name, **k: calls.append(_n) or _r(self, *a, **k))
    for method in ("fused", "scan", "tile"):
        for _ in range(5):
            arr = planner.reserve(arr, 5)
            arr, pos, hd = gg.append(arr, elems, method=method)
            planner.note_append(arr, hd)
    monkeypatch.undo()
    assert calls == [], calls
    assert planner.host_syncs == 0
    np.testing.assert_array_equal(arr.sizes.numpy(), [75, 75, 75, 75])


# --------------------------------------------------------------------------
# convert.py: state carried across packages.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
                                           (jnp.int32, torch.int32)])
def test_jax_grown_array_carried_into_the_port_takes_the_next_wave_identically(jdtype, tdtype):
    rng = np.random.default_rng(21)
    ref = ref_gg.init(5, 2, dtype=jdtype)
    for m in (4, 9):
        ref = ref_gg.ensure_capacity(ref, m)
        ref, _ = ref_gg.push_back(ref, jnp.asarray(rng.standard_normal((5, m)) * 100, jdtype),
                                  jnp.asarray(rng.random((5, m)) < 0.8))
    ours = convert.ggarray_from_numpy([np.asarray(b) for b in ref.buckets], np.asarray(ref.sizes),
                                      ref.b0, device="cpu")
    assert ours.dtype == tdtype
    _assert_same(ours, ref)
    elems = jnp.asarray(rng.standard_normal((5, 40)) * 100, jdtype)
    mask = rng.random((5, 40)) < 0.5
    ref = ref_gg.ensure_capacity(ref, 40)
    ours = gg.ensure_capacity(ours, 40)
    ref, pos_r = ref_gg.push_back(ref, elems, jnp.asarray(mask), method="fused")
    ours, pos_o = gg.push_back(ours, convert.tensor_from_numpy(np.asarray(elems), "cpu"),
                               torch.from_numpy(mask), method="fused")
    np.testing.assert_array_equal(pos_o.numpy(), np.asarray(pos_r))
    _assert_same(ours, ref)
    levels, sizes, b0 = convert.ggarray_to_numpy(ours)
    for a, b in zip(levels, ref.buckets):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(sizes, np.asarray(ref.sizes))
    assert b0 == ref.b0
