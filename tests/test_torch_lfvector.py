"""Port of the single LFVector (``repro.core.lfvector``), mirroring
``tests/core/test_lfvector.py`` and held against the reference on the same
pushes: positions, sizes, bucket levels and planner host syncs bitwise, for
each insertion method (``scan``, ``tile`` = K1, ``mxu`` = K2; their plain
versions on the CPU).  No tolerance: pushes move bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LFVector as RefLFVector
from repro_torch import convert
from repro_torch.core import LFVector

METHODS = ["scan", "tile", "mxu"]


def _assert_same(ours: LFVector, theirs: RefLFVector):
    levels, sizes, b0 = convert.ggarray_to_numpy(ours._gg)
    assert b0 == theirs._gg.b0 and len(levels) == len(theirs._gg.buckets)
    for a, b in zip(levels, theirs._gg.buckets):
        np.testing.assert_array_equal(a.view(np.uint32), np.asarray(b).view(np.uint32))
    np.testing.assert_array_equal(sizes, np.asarray(theirs._gg.sizes))
    assert len(ours) == len(theirs) and ours.capacity == theirs.capacity
    assert ours.nbuckets == theirs.nbuckets
    assert ours._planner.host_syncs == theirs._planner.host_syncs
    np.testing.assert_array_equal(ours.to_array().numpy(), np.asarray(theirs.to_array()))


@pytest.mark.parametrize("method", METHODS)
def test_push_back_grow_and_read(method):
    v = LFVector.create(b0=2, device="cpu")
    idx = v.push_back(torch.tensor([1.0, 2.0, 3.0]), method=method)
    np.testing.assert_array_equal(idx.numpy(), [0, 1, 2])
    assert len(v) == 3 and v.nbuckets >= 2
    np.testing.assert_array_equal(v.to_array().numpy(), [1, 2, 3])


@pytest.mark.parametrize("method", METHODS)
def test_setitem_getitem(method):
    v = LFVector.create(b0=2, device="cpu")
    v.push_back(torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0]), method=method)
    v[2] = 30.0
    assert float(v[2]) == 30.0
    np.testing.assert_array_equal(v.to_array().numpy(), [1, 2, 30, 4, 5])


@pytest.mark.parametrize("method", METHODS)
def test_capacity_bound_matches_paper(method):
    v = LFVector.create(b0=4, device="cpu")
    for _ in range(6):
        v.push_back(torch.ones(7), method=method)
    assert v.capacity < 2 * len(v) + 4  # §V bound


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("b0", [1, 3, 8])
def test_pushes_match_reference_bitwise(method, b0):
    rng = np.random.default_rng(b0 * 10 + len(method))
    ours, theirs = LFVector.create(b0=b0, device="cpu"), RefLFVector.create(b0=b0)
    for wave in range(6):
        x = rng.standard_normal(int(rng.integers(1, 3 * b0 + 5))).astype(np.float32)
        got = ours.push_back(torch.from_numpy(x), method=method)
        want = theirs.push_back(jnp.asarray(x), method=method)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _assert_same(ours, theirs)
    idx = rng.integers(0, len(theirs), 5)
    np.testing.assert_array_equal(ours[torch.from_numpy(idx)].numpy(),
                                  np.asarray(theirs[jnp.asarray(idx)]))
    ours[int(idx[0])] = -7.0
    theirs[int(idx[0])] = -7.0
    _assert_same(ours, theirs)


def test_scalar_push_and_item_shape():
    v = LFVector.create(b0=2, item_shape=(3,), device="cpu")
    v.push_back(torch.ones((4, 3)))
    assert len(v) == 4 and tuple(v.to_array().shape) == (4, 3)
    w = LFVector.create(b0=2, device="cpu")
    np.testing.assert_array_equal(w.push_back(5.0).numpy(), [0])
