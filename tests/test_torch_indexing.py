"""Port of bucket geometry, the global index table and the §V bound, held
against ``repro.core.indexing`` / ``repro.core.theory``.  Integer results:
compared exactly; the theory model's floats: exactly too (same arithmetic)."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import indexing as ref_ix
from repro.core import theory as ref_th
from repro_torch.core import indexing as ix
from repro_torch.core import theory as th

import torch


@pytest.mark.parametrize("b0,nb", [(1, 1), (2, 5), (3, 4), (8, 9), (2048, 8)])
def test_static_geometry_matches_reference(b0, nb):
    assert ix.bucket_sizes(b0, nb) == ref_ix.bucket_sizes(b0, nb)
    assert ix.bucket_starts(b0, nb) == ref_ix.bucket_starts(b0, nb)
    assert ix.capacity(b0, nb) == ref_ix.capacity(b0, nb)
    for n in (0, 1, b0, 3 * b0 + 1, ix.capacity(b0, nb)):
        assert ix.min_buckets_for(b0, n) == ref_ix.min_buckets_for(b0, n)


@pytest.mark.parametrize("b0,nb", [(1, 6), (3, 4), (8, 3)])
def test_position_to_level_and_offset_match_reference(b0, nb):
    pos = np.arange(ix.capacity(b0, nb), dtype=np.int32)
    lvl = ix.bucket_of_position(torch.from_numpy(pos), b0, nb)
    ref_lvl = ref_ix.bucket_of_position(jnp.asarray(pos), b0, nb)
    np.testing.assert_array_equal(lvl.numpy(), np.asarray(ref_lvl))
    off = ix.local_offset(torch.from_numpy(pos), lvl, b0, nb)
    ref_off = ref_ix.local_offset(jnp.asarray(pos), ref_lvl, b0, nb)
    np.testing.assert_array_equal(off.numpy(), np.asarray(ref_off))
    # the kernels' closed form: level = floor(log2(pos / B0 + 1))
    np.testing.assert_array_equal(lvl.numpy(), np.floor(np.log2(pos // b0 + 1)).astype(np.int32))


@pytest.mark.parametrize("sizes", [[5, 1, 7], [0, 0, 3, 0, 2, 0], [4], [0, 0, 0]])
def test_block_starts_and_find_block_with_empty_blocks(sizes):
    s = np.asarray(sizes, np.int32)
    starts = ix.block_starts(torch.from_numpy(s))
    ref_starts = ref_ix.block_starts(jnp.asarray(s))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(ref_starts))
    assert starts.dtype == torch.int32
    idx = np.arange(-1, int(s.sum()) + 2, dtype=np.int32)
    got = ix.find_block(starts, torch.from_numpy(idx))
    want = ref_ix.find_block(ref_starts, jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(int(s.sum())):  # the owner of every live index is non-empty
        assert s[int(got[i + 1])] > 0


@pytest.mark.parametrize("n_per_block", [1, 2, 7, 8, 9, 63, 64, 1000])
@pytest.mark.parametrize("b0", [1, 3, 8])
def test_memory_bound_per_block(n_per_block, b0):
    """Paper §V: allocated capacity stays < 2×size + B0 per block."""
    cap = ix.capacity(b0, max(ix.min_buckets_for(b0, n_per_block), 1))
    assert n_per_block <= cap < 2 * n_per_block + b0


def test_theory_model_matches_reference():
    ours, ref = th.MemoryModel(n0=10_000, nblocks=64, b0=8), ref_th.MemoryModel(n0=10_000, nblocks=64, b0=8)
    for s in (1_000, 123_456, 1_000_000):
        assert ours.ggarray_capacity(s) == ref.ggarray_capacity(s)
        assert ours.ggarray_capacity(s) < 2 * s + 2 * ours.b0 * ours.nblocks
    assert ours.expected(1.0, samples=256) == ref.expected(1.0, samples=256)
    curves, ref_curves = th.memory_curves(np.linspace(0, 2, 3)), ref_th.memory_curves(np.linspace(0, 2, 3))
    for k in ref_curves:
        np.testing.assert_array_equal(curves[k], ref_curves[k])
