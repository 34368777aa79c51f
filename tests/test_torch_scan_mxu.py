"""Port of the tensor-core scan (K2, ``kernels/scan_mxu``), held against
``repro.kernels.scan_mxu`` (its Pallas kernel in interpret mode on the CPU).
int32 exactly; f32 within the reference test's rtol=1e-3, atol=1e-4 (another
summation order).  Full-range int32, where the reference kernel's f32 product
is not exact, is held against the reference's ``ref.row_scan`` (its
``jnp.cumsum``), bitwise, wrap-around included.  The byte-plane construction
the CUDA kernel uses is checked in numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.scan_mxu import ops as ref_ops
from repro.kernels.scan_mxu import ref as ref_ref
from repro_torch.kernels.scan_mxu import kernel, ops, ref

SHAPES = [(1, 1), (1, 128), (3, 100), (8, 256), (5, 513), (16, 1024), (2, 4096)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_row_scan_matches_reference_kernel(shape, dtype):
    rng = np.random.default_rng(shape[0] * 7919 + shape[1] + (dtype == "int32"))
    if dtype == "int32":
        x = rng.integers(0, 2, shape).astype(np.int32)  # insertion-mask regime
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(ref_ops.row_scan(jnp.asarray(x)))
    got = ops.row_scan(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    if dtype == "int32":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def test_carry_stays_exact_for_long_mask_rows():
    n = 1 << 15
    x = np.ones((1, n), np.int32)
    want = np.asarray(ref_ops.row_scan(jnp.asarray(x)))
    got = ops.row_scan(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, -1] == n


@pytest.mark.parametrize("shape", [(3, 1000), (17, 2049)])
def test_full_range_int32_wraps_like_the_reference(shape):
    rng = np.random.default_rng(shape[1])
    x = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, shape, dtype=np.int64)
    x = x.astype(np.int32)
    want = np.asarray(ref_ref.row_scan(jnp.asarray(x)))
    got = ops.row_scan(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    wrap = (np.cumsum(x.astype(np.int64), axis=1) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(got, wrap)


def test_scan_is_per_row_independent():
    x = torch.tensor([[1, 1, 1, 1], [0, 1, 0, 1]], dtype=torch.int32)
    np.testing.assert_array_equal(ops.row_scan(x).numpy(), [[1, 2, 3, 4], [0, 1, 1, 2]])


@pytest.mark.parametrize("seed", [0, 1])
def test_byte_plane_construction_is_exact_modulo_2_32(seed):
    """The kernel's int32 arithmetic: scan each byte plane in 32-column
    chunks (partial sums <= 32 * 255), recombine with shifts, add the running
    carry — all modulo 2^32 — equals the wrapping cumsum."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, (4, 96), dtype=np.uint64).astype(np.uint32)
    chunk = x.reshape(4, 3, 32).astype(np.uint64)
    local = np.zeros_like(chunk)
    for p in range(4):
        plane = (chunk >> (8 * p)) & 0xFF
        scan = np.cumsum(plane, axis=2)
        assert scan.max() <= 32 * 255
        local = (local + (scan << (8 * p))) & 0xFFFFFFFF
    carry = np.concatenate([np.zeros((4, 1), np.uint64), np.cumsum(local[:, :, -1], axis=1)[:, :-1]],
                           axis=1) & 0xFFFFFFFF
    got = ((local + carry[:, :, None]) & 0xFFFFFFFF).reshape(4, 96)
    want = np.cumsum(x.astype(np.uint64), axis=1) & 0xFFFFFFFF
    np.testing.assert_array_equal(got, want)


def test_non_cpu_tensors_go_to_the_kernel_which_wants_cuda():
    x = torch.ones((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        ops.row_scan(x)
    with pytest.raises(ValueError, match="expected"):
        ops.row_scan(torch.ones((3,), dtype=torch.int32))
    assert set(kernel.DTYPES) == {torch.int32, torch.float32}
    assert torch.equal(ref.row_scan(torch.ones((1, 4), dtype=torch.int32)),
                       torch.tensor([[1, 2, 3, 4]], dtype=torch.int32))
