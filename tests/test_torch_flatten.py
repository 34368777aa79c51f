"""Port of the flatten kernels' functions (K6 compaction, K7 segmented
gather) and their wrappers, held **bitwise** against
``repro.kernels.flatten.ops`` (Pallas interpret mode on the CPU).  Ragged
sizes, empty blocks, non-aligned ``nblocks`` and bf16 included.  Tolerance:
none — flatten moves bits."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ggarray as ref_gg
from repro.core import indexing as ref_ix
from repro.kernels.flatten import ops as ref_ops
from repro_torch import convert
from repro_torch.core import ggarray as gg
from repro_torch.core import indexing
from repro_torch.kernels.flatten import ops, ref

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "i32": (jnp.int32, torch.int32)}


def _bits(x) -> np.ndarray:
    a = convert.tensor_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _pair(nblocks, b0, nbuckets, dtype_key, seed, empty_every=0):
    """The same ragged array in both packages (levels hold junk past sizes,
    so a kernel that reads a dead slot shows)."""
    jdtype, _ = DTYPES[dtype_key]
    rng = np.random.default_rng(seed)
    cap = ref_ix.capacity(b0, nbuckets)
    sizes = rng.integers(0, cap + 1, nblocks).astype(np.int32)
    if empty_every:
        sizes[::empty_every] = 0
    levels = tuple(
        jnp.asarray(rng.integers(-1000, 1000, (nblocks, w)) if dtype_key == "i32"
                    else rng.standard_normal((nblocks, w)), jdtype)
        for w in ref_ix.bucket_sizes(b0, nbuckets)
    )
    ours = tuple(convert.tensor_from_numpy(np.asarray(lv), "cpu") for lv in levels)
    return levels, jnp.asarray(sizes), ours, torch.from_numpy(sizes)


@pytest.mark.parametrize("dtype_key", sorted(DTYPES))
@pytest.mark.parametrize("nblocks,b0,nbuckets", [(4, 2, 3), (3, 1, 5), (5, 3, 1), (8, 8, 2)])
def test_compact_blocks_matches_reference(dtype_key, nblocks, b0, nbuckets):
    levels, _, ours, _ = _pair(nblocks, b0, nbuckets, dtype_key, nblocks * 10 + b0)
    want = ref_ops.compact_blocks(levels, b0)
    got = ops.compact_blocks(ours, b0)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype_key", sorted(DTYPES))
@pytest.mark.parametrize(
    "nblocks,b0,nbuckets,empty_every", [(3, 2, 4, 0), (5, 3, 3, 2), (13, 1, 5, 3), (8, 8, 1, 0), (7, 2, 2, 1)]
)
def test_flatten_segmented_matches_reference(dtype_key, nblocks, b0, nbuckets, empty_every):
    seed = zlib.crc32(repr((nblocks, b0, nbuckets, dtype_key, empty_every)).encode())
    levels, sizes_j, ours, sizes_t = _pair(nblocks, b0, nbuckets, dtype_key, seed, empty_every)
    want = np.asarray(ref_ops.flatten_segmented(levels, sizes_j, b0))
    got = ops.flatten_segmented(ours, sizes_t, b0)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    scatter_form = ref.flatten_global(ref.compact_blocks(ours, b0), sizes_t)
    np.testing.assert_array_equal(_bits(scatter_form), _bits(want))
    n = int(sizes_t.sum())
    assert not np.any(_bits(got)[n:]), "dead slots must be zero"


@pytest.mark.parametrize("sizes", [[0, 3, 0, 0, 2], [4, 0], [0, 0, 0], [1, 2, 3]])
def test_gather_global_empty_blocks_match_reference(sizes):
    """Empty blocks share their start with the next block: the owner search
    must be an upper bound (a lower bound puts the empty block's row there)."""
    rng = np.random.default_rng(len(sizes))
    cap = 4
    compact = rng.standard_normal((len(sizes), cap)).astype(np.float32)
    s = np.asarray(sizes, np.int32)
    starts = np.cumsum(s) - s
    ends = starts + s
    want = ref_ops._ref.gather_global(jnp.asarray(compact), jnp.asarray(starts), jnp.asarray(ends))
    got = ref.gather_global(torch.from_numpy(compact), torch.from_numpy(starts), torch.from_numpy(ends))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    expect = np.concatenate([compact[b, :n] for b, n in enumerate(sizes)])
    np.testing.assert_array_equal(got.numpy()[: len(expect)], expect)


@pytest.mark.parametrize("nblocks,b0,nbuckets", [(4, 2, 3), (8, 4, 3)])
@pytest.mark.parametrize("impl", ["segmented", "dispatch"])
def test_flatten_impls_match_reference_and_core(nblocks, b0, nbuckets, impl):
    levels, sizes_j, ours, sizes_t = _pair(nblocks, b0, nbuckets, "f32", 7)
    want = ref_ops.flatten(levels, sizes_j, b0, impl=impl)
    got = ops.flatten(ours, sizes_t, b0, impl=impl)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    core, total = gg.flatten(gg.GGArray(buckets=ours, sizes=sizes_t, b0=b0))
    np.testing.assert_array_equal(_bits(got), _bits(core))
    assert int(total) == int(sizes_t.sum())


def test_flatten_rejects_unknown_impl_and_memory_space():
    _, _, ours, sizes_t = _pair(2, 2, 2, "f32", 0)
    with pytest.raises(ValueError):
        ops.flatten(ours, sizes_t, 2, impl="nope")
    with pytest.raises(ValueError):
        ops.flatten(ours, sizes_t, 2, memory_space="smem")
    for space in (None, "vmem", "hbm"):
        assert torch.equal(ops.flatten(ours, sizes_t, 2, memory_space=space),
                           ops.flatten(ours, sizes_t, 2))


def test_dispatch_off_the_cpu_raises_until_k5_is_ported():
    levels = (torch.zeros((2, 2), device="meta"),)
    with pytest.raises(NotImplementedError, match="K5"):
        ops.flatten(levels, torch.zeros(2, dtype=torch.int32, device="meta"), 2, impl="dispatch")


def test_from_flat_inverts_the_freeze_order():
    flat = torch.arange(37, dtype=torch.float32)
    arr = gg.from_flat(flat, 37, nblocks=4, b0=2)
    out = ops.flatten(arr.buckets, arr.sizes, arr.b0)
    np.testing.assert_array_equal(out.numpy()[:37], flat.numpy())
    ref_arr = ref_gg.from_flat(jnp.arange(37, dtype=jnp.float32), 37, nblocks=4, b0=2)
    np.testing.assert_array_equal(arr.sizes.numpy(), np.asarray(ref_arr.sizes))
    assert indexing.capacity(2, arr.nbuckets) == ref_arr.capacity_per_block
