"""Port of the fused push-back (K3 and its plain version), held **bitwise**
against ``repro.kernels.push_back.ops.push_back_fused`` (Pallas interpret
mode on the CPU): the same inputs, made with numpy from a seed, go through
both packages.  Tolerance: none — push-back moves bits and counts lanes."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ggarray as ref_gg
from repro.kernels.push_back import ops as ref_pb
from repro_torch import convert
from repro_torch.core import ggarray as gg
from repro_torch.kernels.push_back import ops as pb

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16), (jnp.int32, torch.int32)]


def _bits(x) -> np.ndarray:
    a = convert.tensor_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _t(x) -> torch.Tensor:
    return convert.tensor_from_numpy(np.asarray(x), "cpu")


def _random_wave(rng, nblocks, m, jdtype):
    if jnp.issubdtype(jdtype, jnp.integer):
        elems = rng.integers(-1000, 1000, (nblocks, m))
    else:
        elems = rng.standard_normal((nblocks, m))
    mask = rng.random((nblocks, m)) < 0.6
    return jnp.asarray(elems, jdtype), mask


def _assert_same(ours: gg.GGArray, ref: ref_gg.GGArray):
    assert ours.nbuckets == ref.nbuckets
    for a, b in zip(ours.buckets, ref.buckets):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(ours.sizes.numpy(), np.asarray(ref.sizes))


@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: str(d[1]))
@pytest.mark.parametrize(
    "nblocks,b0,waves",
    [
        (4, 4, [3, 5, 2]),
        (5, 3, [1, 7, 4, 6]),
        (2, 2, [9]),
        (8, 1, [1, 1, 1, 1, 1]),
        (3, 4, [130]),
    ],
)
def test_round_trip_matches_reference_bitwise(dtypes, nblocks, b0, waves):
    jdtype, tdtype = dtypes
    rng = np.random.default_rng(zlib.crc32(repr((str(tdtype), nblocks, b0, waves)).encode()))
    ref = ref_gg.init(nblocks, b0, dtype=jdtype, nbuckets=1)
    ours = gg.init(nblocks, b0, dtype=tdtype, nbuckets=1, device="cpu")
    for m in waves:
        elems, mask = _random_wave(rng, nblocks, m, jdtype)
        ref = ref_gg.ensure_capacity(ref, m)
        ours = gg.ensure_capacity(ours, m)
        ref, pos_r = ref_gg.push_back(ref, elems, jnp.asarray(mask), method="fused")
        ours, pos_o = gg.push_back(ours, _t(elems), torch.from_numpy(mask), method="fused")
        np.testing.assert_array_equal(pos_o.numpy(), np.asarray(pos_r))
    _assert_same(ours, ref)


@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: str(d[1]))
@pytest.mark.parametrize("nblocks,b0,nlev,m", [(6, 2, 3, 11), (5, 3, 1, 1), (3, 2, 4, 130)])
def test_ops_match_reference_from_ragged_sizes(dtypes, nblocks, b0, nlev, m):
    """Direct ``push_back_fused`` from ragged, partly full sizes — including
    rows that overflow the last level."""
    jdtype, tdtype = dtypes
    rng = np.random.default_rng(nblocks * 100 + m)
    arr = ref_gg.init(nblocks, b0, dtype=jdtype, nbuckets=nlev)
    levels = tuple(jnp.asarray(rng.standard_normal(b.shape) * 50, jdtype) for b in arr.buckets)
    sizes = rng.integers(0, arr.capacity_per_block + 1, (nblocks,)).astype(np.int32)
    elems, mask = _random_wave(rng, nblocks, m, jdtype)
    want = ref_pb.push_back_fused(levels, jnp.asarray(sizes), b0, elems, jnp.asarray(mask))
    ours_levels = tuple(_t(lv) for lv in levels)
    got = pb.push_back_fused(ours_levels, torch.from_numpy(sizes), b0, _t(elems), torch.from_numpy(mask))
    assert got[0] is ours_levels, "levels are written in place"
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("memory_space", [None, "vmem", "hbm"])
@pytest.mark.parametrize("dispatch", ["auto", "onehot", "mxu"])
def test_tpu_knobs_are_accepted_and_change_nothing(memory_space, dispatch):
    rng = np.random.default_rng(3)
    sizes = torch.from_numpy(rng.integers(0, 4, (4,)).astype(np.int32))
    elems = torch.from_numpy(rng.standard_normal((4, 9)).astype(np.float32))
    mask = torch.from_numpy(rng.random((4, 9)) < 0.5)
    base = pb.push_back_fused(gg.init(4, 2, nbuckets=3, device="cpu").buckets, sizes, 2, elems, mask)
    got = pb.push_back_fused(gg.init(4, 2, nbuckets=3, device="cpu").buckets, sizes, 2, elems, mask,
                             memory_space=memory_space, dispatch=dispatch)
    for a, b in zip(got[0] + got[1:], base[0] + base[1:]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        pb.push_back_fused(base[0], sizes, 2, elems, mask, dispatch="bogus")
    with pytest.raises(ValueError):
        pb.push_back_fused(base[0], sizes, 2, elems, mask, memory_space="smem")


def test_overflow_drops_match_reference():
    """Past-capacity writes are dropped; positions and sizes still count them."""
    ref = ref_gg.init(2, 2, nbuckets=1)
    elems = np.arange(10, dtype=np.float32).reshape(2, 5)
    for method in ("fused", "scan"):
        ours = gg.init(2, 2, nbuckets=1, device="cpu")
        ours, pos_o, hd_o = gg.append(ours, torch.from_numpy(elems), method=method)
        ref2, pos_r, hd_r = ref_gg.append(ref_gg.init(2, 2, nbuckets=1), jnp.asarray(elems), method=method)
        np.testing.assert_array_equal(pos_o.numpy(), np.asarray(pos_r))
        np.testing.assert_array_equal(pos_o.numpy(), [[0, 1, 2, 3, 4]] * 2)
        _assert_same(ours, ref2)
        assert int(hd_o) == int(hd_r) == -3


def test_empty_wave_is_identity():
    arr = gg.init(2, 2, nbuckets=2, device="cpu")
    arr, _ = gg.push_back(arr, torch.ones((2, 3)))
    out, pos = gg.push_back(arr, torch.zeros((2, 0)), method="fused")
    assert pos.shape == (2, 0)
    assert torch.equal(out.sizes, arr.sizes)
    for a, b in zip(out.buckets, arr.buckets):
        assert torch.equal(a, b)


def test_nonscalar_items_match_reference():
    rng = np.random.default_rng(5)
    elems = jnp.asarray(rng.standard_normal((3, 6, 2, 3)), jnp.bfloat16)
    mask = rng.random((3, 6)) < 0.7
    ref, pos_r = ref_gg.push_back(ref_gg.init(3, 2, item_shape=(2, 3), dtype=jnp.bfloat16, nbuckets=3),
                                  elems, jnp.asarray(mask), method="fused")
    for method in ("fused", "scan"):
        ours, pos_o = gg.push_back(gg.init(3, 2, item_shape=(2, 3), dtype=torch.bfloat16, nbuckets=3,
                                           device="cpu"), _t(elems), torch.from_numpy(mask), method=method)
        np.testing.assert_array_equal(pos_o.numpy(), np.asarray(pos_r))
        _assert_same(ours, ref)


def test_int_mask_counts_lanes_not_values():
    arr = gg.init(1, 4, nbuckets=2, device="cpu")
    mask = torch.tensor([[3, 0, 7]], dtype=torch.int32)
    for method in ("fused", "scan"):
        out, pos = gg.push_back(arr, torch.tensor([[1.0, 2.0, 3.0]]), mask, method=method)
        assert int(out.sizes[0]) == 2, method
        np.testing.assert_array_equal(pos.numpy(), [[0, -1, 1]])


def test_multi_group_plain_path_shares_one_mask():
    rng = np.random.default_rng(9)
    mask = torch.from_numpy(rng.random((3, 7)) < 0.5)
    sizes = torch.tensor([0, 2, 5], dtype=torch.int32)
    g1 = gg.init(3, 2, nbuckets=3, device="cpu").buckets
    g2 = gg.init(3, 2, item_shape=(4,), dtype=torch.bfloat16, nbuckets=3, device="cpu").buckets
    e1 = torch.from_numpy(rng.standard_normal((3, 7)).astype(np.float32))
    e2 = torch.from_numpy(rng.standard_normal((3, 7, 4)).astype(np.float32)).to(torch.bfloat16)
    groups, sizes_m, pos_m = pb.push_back_fused_multi((g1, g2), sizes, 2, (e1, e2), mask)
    for grp, e in zip(groups, (e1, e2)):
        fresh = tuple(torch.zeros_like(lv) for lv in grp)
        one, s1, p1 = pb.push_back_fused(fresh, sizes, 2, e, mask)
        for a, b in zip(grp, one):
            assert torch.equal(a, b)
        assert torch.equal(s1, sizes_m) and torch.equal(p1, pos_m)


@pytest.mark.parametrize("nblocks,b0,nlev,m", [(4, 8, 2, 1), (3, 2, 4, 5), (5, 3, 1, 9)])
def test_two_groups_match_reference_multi_group(nblocks, b0, nlev, m):
    """The KV cache's append: k and v as two payload groups of (KH, D) bf16
    items sharing one mask, against the reference's multi-group kernel
    (interpret mode), bitwise — levels, sizes and positions."""
    rng = np.random.default_rng(nblocks * 100 + m)
    widths = [b0 << b for b in range(nlev)]
    item = (2, 4)
    levels = [[np.asarray(jnp.asarray(rng.standard_normal((nblocks, w, *item)), jnp.bfloat16))
               for w in widths] for _ in range(2)]
    elems = [np.asarray(jnp.asarray(rng.standard_normal((nblocks, m, *item)), jnp.bfloat16))
             for _ in range(2)]
    cap = b0 * ((1 << nlev) - 1)
    sizes = rng.integers(0, cap + 1, nblocks).astype(np.int32)
    mask = rng.random((nblocks, m)) < (1.0 if m == 1 else 0.6)
    theirs = ref_pb.push_back_fused_multi(
        tuple(tuple(jnp.asarray(x) for x in g) for g in levels), jnp.asarray(sizes), b0,
        tuple(jnp.asarray(e) for e in elems), jnp.asarray(mask), interpret=True)
    groups = tuple(tuple(_t(x) for x in g) for g in levels)
    ours = pb.push_back_fused_multi(groups, torch.from_numpy(sizes), b0,
                                    tuple(_t(e) for e in elems), torch.from_numpy(mask))
    assert ours[0] is groups  # written in place
    for g_ours, g_theirs in zip(ours[0], theirs[0]):
        for a, b in zip(g_ours, g_theirs):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(theirs[2]))


def test_multi_group_launcher_checks_groups_before_the_card():
    from repro_torch.kernels.push_back import kernel as k_pb

    meta = torch.device("meta")
    lv = (torch.zeros((2, 2, 3), device=meta),)
    e = torch.zeros((2, 1, 3), device=meta)
    sizes = torch.zeros(2, dtype=torch.int32, device=meta)
    mask = torch.ones((2, 1), dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="expected cuda"):
        pb.push_back_fused_multi((lv, lv), sizes, 2, (e, e), mask)
    with pytest.raises(ValueError, match="supported 1..4"):
        k_pb.push_back_cuda_multi((lv,) * 5, sizes, 2, (e,) * 5, mask)
    with pytest.raises(ValueError, match="equal counts"):
        k_pb.push_back_cuda_multi((lv, lv), sizes, 2, (e,), mask)


@pytest.mark.parametrize("nblocks,b0,nlev,m", [(4, 8, 2, 1), (3, 2, 4, 5), (5, 3, 1, 9)])
def test_four_groups_int8_and_bf16_scales_match_reference(nblocks, b0, nlev, m):
    """An int8 cache's append: int8 k and v of (KH, D) and their bf16
    scales of (KH,), four payload groups sharing one mask, against the
    reference's multi-group plain path (``use_ref=True``), bitwise —
    levels, sizes and positions."""
    rng = np.random.default_rng(nblocks * 1000 + m)
    widths = [b0 << b for b in range(nlev)]
    kh, d = 2, 8

    def codes(*shape):
        return rng.integers(-127, 128, shape).astype(np.int8)

    def scales(*shape):
        return np.asarray(jnp.asarray(rng.random(shape), jnp.bfloat16))

    make = (codes, codes, scales, scales)
    items = ((kh, d), (kh, d), (kh,), (kh,))
    levels = [[f(nblocks, w, *it) for w in widths] for f, it in zip(make, items)]
    elems = [f(nblocks, m, *it) for f, it in zip(make, items)]
    sizes = rng.integers(0, b0 * ((1 << nlev) - 1) + 1, nblocks).astype(np.int32)
    mask = rng.random((nblocks, m)) < (1.0 if m == 1 else 0.6)
    theirs = ref_pb.push_back_fused_multi(
        tuple(tuple(jnp.asarray(x) for x in g) for g in levels), jnp.asarray(sizes), b0,
        tuple(jnp.asarray(e) for e in elems), jnp.asarray(mask), use_ref=True)
    groups = tuple(tuple(_t(x) for x in g) for g in levels)
    ours = pb.push_back_fused_multi(groups, torch.from_numpy(sizes), b0,
                                    tuple(_t(e) for e in elems), torch.from_numpy(mask))
    assert ours[0] is groups  # written in place
    assert [g[0].dtype for g in groups] == [torch.int8, torch.int8, torch.bfloat16, torch.bfloat16]
    for g_ours, g_theirs in zip(ours[0], theirs[0]):
        for a, b in zip(g_ours, g_theirs):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(theirs[2]))


def test_int8_payloads_are_admitted_and_four_groups_count_apart():
    from repro_torch.kernels import common
    from repro_torch.kernels.push_back import kernel as k_pb

    assert torch.int8 in k_pb.PAYLOAD_DTYPES
    assert [k_pb.launch_name(n) for n in (1, 2, 3, 4)] == [
        "push_back", "push_back_multi", "push_back_multi", "push_back_four"]
    assert {"push_back", "push_back_multi", "push_back_four"} <= set(common.KERNELS)
    meta = torch.device("meta")
    lv = (torch.zeros((2, 2, 3), dtype=torch.int8, device=meta),)
    e = torch.zeros((2, 1, 3), dtype=torch.int8, device=meta)
    sizes = torch.zeros(2, dtype=torch.int32, device=meta)
    mask = torch.ones((2, 1), dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="expected cuda"):  # past the dtype check
        k_pb.push_back_cuda_multi((lv,) * 4, sizes, 2, (e,) * 4, mask)
