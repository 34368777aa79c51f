"""Port of dispatch (K5a) and combine (K5b) (``kernels/dispatch_mxu``), held
against ``repro.kernels.dispatch_mxu`` (its Pallas kernels in interpret mode
on the CPU) and its ``ref`` oracles.  With unique positions — the freeze's
case — dispatch moves bits: bitwise.  Where positions repeat, float sums
depend on the order of the adds: within the reference test's 2e-2 (bf16) /
1e-6 (f32).  int32 payloads past 2^24, which the reference kernel's f32
product rounds, are exact against the reference oracle.  Combine is a
gather: bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dispatch_mxu import ops as ref_ops
from repro.kernels.dispatch_mxu import ref as ref_ref
from repro.kernels.flatten import ops as ref_flatten
from repro_torch import convert
from repro_torch.kernels.dispatch_mxu import kernel, ops
from repro_torch.kernels.flatten import ops as flatten_ops

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(x) -> np.ndarray:
    a = convert.tensor_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _inputs(T, S, D, dtype, seed, unique=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    if unique:  # distinct slots, ~20% of lanes dropped (push_back semantics)
        perm = np.concatenate([rng.permutation(S), np.full(max(T - S, 0), -1)])[:T]
        pos = np.where(rng.random(T) < 0.8, perm, -1).astype(np.int32)
    else:  # T > S lanes over S slots: slots repeat
        pos = np.where(rng.random(T) < 0.8, rng.integers(0, S, T), -1).astype(np.int32)
    jx = jnp.asarray(x, DTYPES[dtype][0])
    return jx, convert.tensor_from_numpy(np.asarray(jx), "cpu"), pos


@pytest.mark.parametrize("T,S,D", [(8, 16, 8), (100, 64, 32), (128, 128, 128), (300, 512, 64)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dispatch_unique_positions_bitwise(T, S, D, dtype):
    jx, tx, pos = _inputs(T, S, D, dtype, T * 1000 + S + D)
    got = ops.dispatch(tx, torch.from_numpy(pos), S)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (S, D)
    np.testing.assert_array_equal(_bits(got), _bits(ref_ref.dispatch(jx, jnp.asarray(pos), S)))
    np.testing.assert_array_equal(_bits(got), _bits(ref_ops.dispatch(jx, jnp.asarray(pos), S)))


@pytest.mark.parametrize("T,S,D", [(100, 64, 32), (130, 50, 16)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dispatch_repeated_positions_within_tolerance(T, S, D, dtype):
    jx, tx, pos = _inputs(T, S, D, dtype, T + 7 * S, unique=False)
    assert len(set(pos[pos >= 0])) < (pos >= 0).sum()  # there are repeats
    got = ops.dispatch(tx, torch.from_numpy(pos), S).float().numpy()
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    for want in (ref_ref.dispatch(jx, jnp.asarray(pos), S), ref_ops.dispatch(jx, jnp.asarray(pos), S)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_dispatch_int32_is_exact_past_2_24():
    rng = np.random.default_rng(5)
    T, S, D = 64, 40, 3
    x = rng.integers(-(2**30), 2**30, (T, D)).astype(np.int32)
    pos = rng.integers(-1, S, T).astype(np.int32)  # repeats and drops
    got = ops.dispatch(torch.from_numpy(x), torch.from_numpy(pos), S).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_ref.dispatch(jnp.asarray(x), jnp.asarray(pos), S)))


def test_dispatch_drops_slots_outside_the_buffer():
    x = torch.arange(1, 5, dtype=torch.float32)[:, None]
    got = ops.dispatch(x, torch.tensor([0, -1, 3, 9], dtype=torch.int32), 4)
    np.testing.assert_array_equal(got[:, 0].numpy(), [1, 0, 0, 3])


@pytest.mark.parametrize("T,S,D", [(8, 16, 8), (64, 256, 32), (130, 100, 16)])
def test_combine_matches_reference(T, S, D):
    rng = np.random.default_rng(T * 31 + S)
    buf = rng.standard_normal((S, D)).astype(np.float32)
    pos = np.where(rng.random(T) < 0.9, rng.integers(0, S, T), -1).astype(np.int32)
    got = ops.combine(torch.from_numpy(buf), torch.from_numpy(pos), T)
    for want in (ref_ops.combine(jnp.asarray(buf), jnp.asarray(pos), T),
                 ref_ref.combine(jnp.asarray(buf), jnp.asarray(pos), T)):
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_dispatch_then_combine_roundtrip():
    T, S, D = 32, 64, 8
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    pos = torch.from_numpy(rng.permutation(S)[:T].astype(np.int32))
    back = ops.combine(ops.dispatch(x, pos, S), pos)
    np.testing.assert_array_equal(back.numpy(), x.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("nblocks,b0,nbuckets", [(4, 2, 3), (7, 4, 3)])
def test_flatten_dispatch_bitwise(dtype, nblocks, b0, nbuckets):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}[dtype]
    rng = np.random.default_rng(nblocks * 100 + b0)
    widths = [b0 << b for b in range(nbuckets)]
    sizes = rng.integers(0, sum(widths) + 1, nblocks).astype(np.int32)
    levels = tuple(jnp.asarray(rng.integers(-1000, 1000, (nblocks, w)), jdt) for w in widths)
    ours = tuple(convert.tensor_from_numpy(np.asarray(lv), "cpu") for lv in levels)
    want = ref_flatten.flatten(levels, jnp.asarray(sizes), b0, impl="dispatch")
    got = flatten_ops.flatten(ours, torch.from_numpy(sizes), b0, impl="dispatch")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got), _bits(flatten_ops.flatten(ours, torch.from_numpy(sizes), b0, impl="segmented")))


def test_non_cpu_tensors_go_to_the_kernels_which_want_cuda():
    x = torch.ones((4, 2), device="meta")
    pos = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        ops.dispatch(x, pos, 4)
    with pytest.raises(ValueError, match="expected cuda"):
        ops.combine(x, pos)
    assert set(kernel.DISPATCH_DTYPES) == {torch.float32, torch.bfloat16, torch.int32}


def test_dispatch_adds_into_zeros_so_negative_zero_becomes_positive():
    """A scatter-add into zeros: 0.0 + (-0.0) is +0.0, in the reference's
    ``.at[].add`` and here alike (the freeze by dispatch therefore equals
    the segmented freeze up to the sign of zero)."""
    x = np.asarray([[-0.0], [1.5], [-0.0]], np.float32)
    pos = np.asarray([2, 0, -1], np.int32)
    got = ops.dispatch(torch.from_numpy(x), torch.from_numpy(pos), 3)
    want = ref_ref.dispatch(jnp.asarray(x), jnp.asarray(pos), 3)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not torch.signbit(got[2, 0])


@pytest.mark.parametrize("n_slots, words", [(1, 5), (31, 5), (32, 5), (33, 6), (2**31 - 1, 4 + 2**26)])
def test_scratch_holds_the_header_then_a_bit_a_slot(n_slots, words):
    assert kernel.SCRATCH_HEADER == 4  # csrc/dispatch.cu's kHeader
    assert kernel.scratch_words(n_slots) == words


def test_atomic_yardstick_wants_cuda_and_checks_like_the_kernel():
    x = torch.ones((4, 2))
    pos = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected cuda"):
        kernel.dispatch_atomic_cuda(x, pos, 4)
    with pytest.raises(ValueError, match="expected cuda"):
        kernel.dispatch_cuda(x.to("meta"), pos.to("meta"), 4)
    assert kernel.dispatch_path("cpu") is None  # no launch on that device
