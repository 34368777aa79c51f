"""Port of the insertion-offset algorithms, held against ``repro.core.insertion``
(its ``tile``/``mxu`` Pallas kernels run in interpret mode on the CPU).
Offsets and counts are integers: compared exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import insertion as ref_ins
from repro_torch.core.insertion import INSERTION_METHODS, insertion_offsets

METHODS = sorted(INSERTION_METHODS)


def test_same_methods_as_reference():
    assert METHODS == sorted(ref_ins.INSERTION_METHODS)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (5, 130), (3, 513)])
def test_matches_reference(method, shape):
    rng = np.random.default_rng(sum(shape) + len(method))
    mask = rng.random(shape) < 0.5
    off, cnt = insertion_offsets(torch.from_numpy(mask), method=method)
    ref_off, ref_cnt = ref_ins.insertion_offsets(jnp.asarray(mask), method=method)
    assert off.dtype == torch.int32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(np.where(mask, off.numpy(), 0), np.where(mask, np.asarray(ref_off), 0))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))


@pytest.mark.parametrize("method", METHODS)
def test_offsets_unique_and_dense(method):
    rng = np.random.default_rng(0)
    mask = rng.random((4, 97)) < 0.3
    off, cnt = insertion_offsets(torch.from_numpy(mask), method=method)
    for b in range(4):
        np.testing.assert_array_equal(np.sort(off[b].numpy()[mask[b]]), np.arange(int(cnt[b])))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.uint8])
def test_integer_mask_counts_lanes_not_values(method, dtype):
    mask = np.asarray([[3, 0, 7], [0, 0, 1]])
    off, cnt = insertion_offsets(torch.from_numpy(mask).to(dtype), method=method)
    ref_off, ref_cnt = ref_ins.insertion_offsets(jnp.asarray(mask, jnp.int32), method=method)
    np.testing.assert_array_equal(cnt.numpy(), [2, 1])
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    valid = mask != 0
    np.testing.assert_array_equal(np.where(valid, off.numpy(), 0), np.where(valid, np.asarray(ref_off), 0))


@pytest.mark.parametrize("method", METHODS)
def test_empty_wave_m0(method):
    off, cnt = insertion_offsets(torch.zeros((3, 0), dtype=torch.bool), method=method)
    assert off.shape == (3, 0) and off.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), [0, 0, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_float_mask_rejected(dtype):
    with pytest.raises(TypeError):
        insertion_offsets(torch.ones((1, 3), dtype=dtype))


def test_rejects_bad_rank_and_method():
    with pytest.raises(ValueError):
        insertion_offsets(torch.ones((3,), dtype=torch.bool))
    with pytest.raises(ValueError):
        insertion_offsets(torch.ones((1, 3), dtype=torch.bool), method="nope")


def test_mxu_off_the_cpu_raises_until_k2_is_ported():
    with pytest.raises(NotImplementedError, match="K2"):
        insertion_offsets(torch.ones((2, 3), dtype=torch.bool, device="meta"), method="mxu")
