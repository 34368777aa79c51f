"""Port of the paper's comparison structures (``repro.core.baselines``),
mirroring ``tests/core/test_baselines.py`` and held against the reference on
the same pushes: data, size, positions and capacity bitwise, for each
insertion method (``scan``, ``tile`` = K1, ``mxu`` = K2, ``atomic``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as rbl
from repro_torch.core import SemiStaticArray, StaticArray, baselines as bl

METHODS = ["scan", "tile", "mxu", "atomic"]


@pytest.mark.parametrize("method", METHODS)
def test_static_push_back_dense_and_masked(method):
    arr = bl.static_init(16, device="cpu")
    arr, pos = bl.static_push_back(arr, torch.tensor([1.0, 2.0, 3.0]), method=method)
    np.testing.assert_array_equal(pos.numpy(), [0, 1, 2])
    mask = torch.tensor([True, False, True])
    arr, pos = bl.static_push_back(arr, torch.tensor([4.0, 5.0, 6.0]), mask, method=method)
    np.testing.assert_array_equal(pos.numpy(), [3, -1, 4])
    np.testing.assert_array_equal(arr.data.numpy()[:5], [1, 2, 3, 4, 6])
    assert int(arr.size) == 5 and isinstance(arr, StaticArray)


def test_static_has_no_resize_overflow_drops():
    arr = bl.static_init(2, device="cpu")
    arr, _ = bl.static_push_back(arr, torch.tensor([1.0, 2.0, 3.0]))
    np.testing.assert_array_equal(arr.data.numpy(), [1, 2])
    theirs, _ = rbl.static_push_back(rbl.static_init(2), jnp.asarray([1.0, 2.0, 3.0]))
    assert int(arr.size) == int(theirs.size) == 3


def test_semistatic_doubles_with_copy():
    arr = SemiStaticArray.create(4, device="cpu")
    arr.push_back(torch.arange(4, dtype=torch.float32))
    assert arr.capacity == 4
    grows = arr.ensure_capacity(5)
    assert grows >= 1 and arr.capacity >= 9 - 1
    arr.push_back(torch.tensor([9.0]))
    np.testing.assert_array_equal(arr.arr.data.numpy()[:5], [0, 1, 2, 3, 9])


def test_semistatic_alloc_only_matches_shape():
    arr = SemiStaticArray.create(8, copy_on_grow=False, device="cpu")
    assert tuple(arr.grow_alloc_only().shape) == (16,)
    assert tuple(rbl.SemiStaticArray.create(8, copy_on_grow=False).grow_alloc_only().shape) == (16,)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("copy_on_grow", [True, False])
def test_semistatic_matches_reference_bitwise(method, copy_on_grow):
    rng = np.random.default_rng(len(method) * 2 + copy_on_grow)
    ours = SemiStaticArray.create(4, copy_on_grow=copy_on_grow, device="cpu")
    theirs = rbl.SemiStaticArray.create(4, copy_on_grow=copy_on_grow)
    for wave in range(7):
        n = int(rng.integers(1, 12))
        x = rng.standard_normal(n).astype(np.float32)
        mask = rng.random(n) < 0.7
        got = ours.push_back(torch.from_numpy(x), torch.from_numpy(mask), method=method)
        want = theirs.push_back(jnp.asarray(x), jnp.asarray(mask), method=method)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert ours.capacity == theirs.capacity and ours.size == theirs.size
        np.testing.assert_array_equal(ours.arr.data.numpy().view(np.uint32),
                                      np.asarray(theirs.arr.data).view(np.uint32))


@pytest.mark.parametrize("method", METHODS)
def test_static_matches_reference_bitwise_past_capacity(method):
    rng = np.random.default_rng(7 + len(method))
    ours, theirs = bl.static_init(24, (2,), device="cpu"), rbl.static_init(24, (2,))
    for wave in range(5):
        x = rng.standard_normal((8, 2)).astype(np.float32)
        mask = rng.random(8) < 0.8
        ours, got = bl.static_push_back(ours, torch.from_numpy(x), torch.from_numpy(mask), method=method)
        theirs, want = rbl.static_push_back(theirs, jnp.asarray(x), jnp.asarray(mask), method=method)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(ours.data.numpy(), np.asarray(theirs.data))
        assert int(ours.size) == int(theirs.size)
