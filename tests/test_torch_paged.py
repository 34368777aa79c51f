"""Port of the paged ops (``repro.kernels.paged``): the paged gather (K8 for
one extent, K9 for several) and the slab append (K12), held against the JAX
package's ops — its Pallas kernels in interpret mode on the CPU — on the same
seeded inputs, bitwise, for f32, int32 and bf16, scalar and non-scalar
items, page −1 and ids past the pool, fuzzed owners/bases tables with free
slabs, and lanes that land past every claimed slab.  Mirrors the gather and
slab-append parts of ``tests/kernels/test_paged.py``; the paged attention
(K10/K11, a float reduction) is held within a stated tolerance against the
reference's interpret-mode kernels."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:
    from _hypothesis_fallback import given, settings, st

from repro.kernels.paged import ops as rops
from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.kernels import common
from repro_torch.kernels.paged import ops
from repro_torch.kernels.paged import ref

DTYPES = {"float32": (np.float32, jnp.float32), "int32": (np.int32, jnp.int32),
          "bfloat16": (None, jnp.bfloat16)}


def _data(rng, shape, dtype):
    """Seeded numpy data of ``dtype`` (bf16 made through JAX's ml_dtypes)."""
    if dtype == "int32":
        return rng.integers(-50, 50, shape).astype(np.int32)
    x = rng.standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16)) if dtype == "bfloat16" else x


def _bits(x) -> np.ndarray:
    """Bit pattern of a port tensor or a JAX/numpy array."""
    a = tensor_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _t(a):
    return tensor_from_numpy(a, "cpu")


def _fleet(rng, S, N, P, npages):
    """Disjoint random slab assignment for N arrays."""
    pages = np.full((N, P), -1, np.int32)
    perm = rng.permutation(S)
    k = 0
    for i, c in enumerate(npages):
        for p in range(c):
            pages[i, p] = perm[k]
            k += 1
    return pages


def _split(pool, cuts):
    return [pool[a:b] for a, b in zip((0,) + cuts, cuts + (len(pool),))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("item", [(), (3,), (2, 2), (8, 128)])
@pytest.mark.parametrize("layout", ["flat", "extents"])
def test_paged_gather_matches_reference(dtype, item, layout):
    rng = np.random.default_rng(0)
    S, T, N, P = 11, 4, 5, 3
    pool = _data(rng, (S, T, *item), dtype)
    pages = _fleet(rng, S, N, P, [3, 0, 2, 1, 3])
    if layout == "flat":
        ours = ops.paged_gather(_t(pool), torch.from_numpy(pages))
        theirs = rops.paged_gather(jnp.asarray(pool), jnp.asarray(pages))
    else:
        exts = _split(pool, (1, 3, 7))
        ours = ops.paged_gather(tuple(_t(e) for e in exts), torch.from_numpy(pages))
        theirs = rops.paged_gather(tuple(jnp.asarray(e) for e in exts), jnp.asarray(pages))
    assert tuple(ours.shape) == (N, P * T, *item)
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))
    assert not _bits(ours)[1].any()  # page −1 reads as zeros


@pytest.mark.parametrize("layout", ["flat", "extents"])
def test_paged_gather_ids_past_the_pool_match_reference(layout):
    """Ids past the pool: the last slab of a flat pool, zeros through extents."""
    rng = np.random.default_rng(1)
    S, T = 6, 2
    pool = rng.standard_normal((S, T)).astype(np.float32)
    pages = np.asarray([[S, -1, 0], [S + 5, 2, -3]], np.int32)
    exts = [pool] if layout == "flat" else _split(pool, (2, 3))
    arg_p = _t(pool) if layout == "flat" else tuple(_t(e) for e in exts)
    arg_r = jnp.asarray(pool) if layout == "flat" else tuple(jnp.asarray(e) for e in exts)
    ours = ops.paged_gather(arg_p, torch.from_numpy(pages))
    np.testing.assert_array_equal(_bits(ours), _bits(rops.paged_gather(arg_r, jnp.asarray(pages))))
    want_first = pool[S - 1] if layout == "flat" else np.zeros(T, np.float32)
    np.testing.assert_array_equal(ours[0, :T].numpy(), want_first)


def test_paged_gather_ragged_and_empty():
    rng = np.random.default_rng(2)
    pool = rng.standard_normal((1, 3, 5)).astype(np.float32)
    for N, P in ((1, 1), (7, 1), (1, 9)):
        pages = rng.integers(-1, 1, (N, P)).astype(np.int32)
        ours = ops.paged_gather(_t(pool), torch.from_numpy(pages))
        theirs = rops.paged_gather(jnp.asarray(pool), jnp.asarray(pages))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    # no rows (the reference's interpreter takes none), and a pool with no
    # slab at all, which reads zeros
    assert ops.paged_gather(_t(pool), torch.zeros((0, 2), dtype=torch.int32)).shape == (0, 6, 5)
    empty = torch.zeros((0, 3, 5))
    got = ops.paged_gather(empty, torch.full((2, 2), -1, dtype=torch.int32))
    assert got.shape == (2, 6, 5) and not bool(got.any())


def _owner_tables(pages, S, T):
    owners = np.full((S,), -1, np.int32)
    bases = np.zeros((S,), np.int32)
    for i in range(pages.shape[0]):
        for p in range(pages.shape[1]):
            if pages[i, p] >= 0:
                owners[pages[i, p]] = i
                bases[pages[i, p]] = p * T
    return owners, bases


def _append_both(pool, owners, bases, sizes, elems, mask, cuts=None):
    """The same append through the port (CPU) and the reference → both."""
    if cuts is None:
        arg_p, arg_r = _t(pool), jnp.asarray(pool)
    else:
        exts = _split(pool, cuts)
        arg_p = tuple(_t(e) for e in exts)
        arg_r = tuple(jnp.asarray(e) for e in exts)
    ours = ops.slab_append(arg_p, torch.from_numpy(owners), torch.from_numpy(bases),
                           torch.from_numpy(sizes), _t(elems), torch.from_numpy(mask))
    theirs = rops.slab_append(arg_r, jnp.asarray(owners), jnp.asarray(bases),
                              jnp.asarray(sizes), jnp.asarray(elems), jnp.asarray(mask))
    return arg_p, ours, theirs


def _assert_append_same(ours, theirs):
    p_pool, r_pool = ours[0], theirs[0]
    if isinstance(p_pool, tuple):
        assert isinstance(r_pool, tuple) and len(p_pool) == len(r_pool)
        for a, b in zip(p_pool, r_pool):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    else:
        np.testing.assert_array_equal(_bits(p_pool), _bits(r_pool))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(theirs[2]))
    assert ours[1].dtype == ours[2].dtype == torch.int32


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("item", [(), (2, 3)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cuts", [None, (5, 9)])
def test_slab_append_matches_reference(dtype, item, masked, cuts):
    rng = np.random.default_rng(2)
    S, T, N, P, m = 14, 4, 4, 4, 3
    pages = _fleet(rng, S, N, P, [4, 2, 3, 4])
    owners, bases = _owner_tables(pages, S, T)
    sizes = np.asarray([7, 1, 5, 10], np.int32)
    pool = _data(rng, (S, T, *item), dtype)
    elems = _data(rng, (N, m, *item), dtype)
    mask = rng.random((N, m)) > 0.4 if masked else np.ones((N, m), bool)
    arg_p, ours, theirs = _append_both(pool, owners, bases, sizes, elems, mask, cuts)
    _assert_append_same(ours, theirs)
    # in place: the pool that came back is the pool that went in
    assert ours[0] is arg_p if cuts is None else all(a is b for a, b in zip(ours[0], arg_p))
    # round trip: gathering back reads the wave at the assigned positions
    view = ops.paged_gather(ours[0], torch.from_numpy(pages))
    pos = ours[2].numpy()
    for i in range(N):
        for lane in range(m):
            if mask[i, lane]:
                np.testing.assert_array_equal(_bits(view[i, pos[i, lane]]), _bits(_t(elems)[i, lane]))


def test_slab_append_leaves_unowned_slabs_untouched():
    rng = np.random.default_rng(3)
    S, T, N, m = 10, 4, 2, 5
    pool = rng.standard_normal((S, T)).astype(np.float32)
    owners = np.full((S,), -1, np.int32)
    owners[4] = 0  # only slab 4 owned
    bases = np.zeros((S,), np.int32)
    sizes = np.zeros((N,), np.int32)
    elems = np.full((N, m), 9.0, np.float32)
    mask = np.asarray([[True] * 4 + [False], [True] * 5])
    _, ours, theirs = _append_both(pool, owners, bases, sizes, elems, mask)
    _assert_append_same(ours, theirs)
    after = ours[0].numpy()
    untouched = [s for s in range(S) if s != 4]
    np.testing.assert_array_equal(after[untouched], pool[untouched])
    np.testing.assert_array_equal(after[4], [9.0] * 4)
    # array 1 owns nothing: its writes drop, but its count still advances
    np.testing.assert_array_equal(ours[1].numpy(), [4, 5])


def test_slab_append_lanes_past_every_slab_are_dropped_but_counted():
    S, T, N, m = 4, 2, 2, 7
    pool = np.zeros((S, T), np.float32)
    owners = np.asarray([0, 0, 1, -1], np.int32)  # array 0 holds 4 slots, array 1 two
    bases = np.asarray([0, 2, 0, 0], np.int32)
    sizes = np.asarray([1, 0], np.int32)
    elems = np.arange(1, N * m + 1, dtype=np.float32).reshape(N, m)
    mask = np.ones((N, m), bool)
    _, ours, theirs = _append_both(pool, owners, bases, sizes, elems, mask)
    _assert_append_same(ours, theirs)
    np.testing.assert_array_equal(ours[1].numpy(), [8, 7])
    np.testing.assert_array_equal(ours[2].numpy()[0], np.arange(1, 8))
    np.testing.assert_array_equal(ours[0].numpy(), [[0, 1], [2, 3], [8, 9], [0, 0]])


def _fuzz_case(seed, S, T, N, m, item, dtype, cuts):
    rng = np.random.default_rng(seed)
    owners = rng.integers(-1, N + 1, S).astype(np.int32)  # free slabs and owners past N
    bases = (rng.integers(0, 5, S) * T + rng.integers(-1, 2, S) * rng.integers(0, 2, S)).astype(np.int32)
    sizes = rng.integers(0, 3 * T, N).astype(np.int32)
    pool = _data(rng, (S, T, *item), dtype)
    elems = _data(rng, (N, m, *item), dtype)
    mask = rng.random((N, m)) < rng.random()
    _, ours, theirs = _append_both(pool, owners, bases, sizes, elems, mask, cuts)
    _assert_append_same(ours, theirs)


@given(st.integers(0, 2**31 - 1), st.integers(1, 9), st.integers(1, 5), st.integers(1, 4),
       st.integers(1, 11), st.sampled_from([(), (3,)]), st.sampled_from(list(DTYPES)),
       st.sampled_from([None, (1,), (2, 3)]))
@settings(max_examples=25, deadline=None)
def test_slab_append_fuzzed_tables_match_reference(seed, S, T, N, m, item, dtype, cuts):
    """Any owners/bases table — free slabs, owners past N (clamped), shared
    and overlapping windows, misaligned bases — gives the reference's pool."""
    if cuts is not None and cuts[-1] >= S:
        cuts = None
    _fuzz_case(seed, S, T, N, m, item, dtype, cuts)


@pytest.mark.parametrize("seed", range(6))
def test_slab_append_fuzzed_tables_seeded(seed):
    _fuzz_case(seed, 9, 3, 4, 7, (2,), "float32" if seed % 2 else "bfloat16", (3, 4))


def test_slab_append_int_mask_and_empty_wave():
    pool = torch.zeros((2, 2))
    owners = torch.tensor([0, 1], dtype=torch.int32)
    bases = torch.zeros(2, dtype=torch.int32)
    sizes = torch.zeros(2, dtype=torch.int32)
    out = ops.slab_append(pool, owners, bases, sizes, torch.ones((2, 3)),
                          torch.tensor([[1, 0, 2], [0, 0, 0]]))
    np.testing.assert_array_equal(out[1].numpy(), [2, 0])
    np.testing.assert_array_equal(out[2].numpy(), [[0, -1, 1], [-1, -1, -1]])
    empty = ops.slab_append(pool, owners, bases, sizes, torch.ones((2, 0)),
                            torch.ones((2, 0), dtype=torch.bool))
    assert empty[2].shape == (2, 0) and empty[1] is not None


def test_plain_version_matches_reference_oracle():
    """``ref.slab_append`` (scatter compaction) against the reference's
    one-hot oracle on a flat pool."""
    from repro.kernels.paged import ref as rref

    rng = np.random.default_rng(7)
    S, T, N, m = 6, 3, 3, 5
    pool = rng.standard_normal((S, T, 2)).astype(np.float32)
    owners = rng.integers(-1, N, S).astype(np.int32)
    bases = (rng.integers(0, 3, S) * T).astype(np.int32)
    sizes = rng.integers(0, 4, N).astype(np.int32)
    elems = rng.standard_normal((N, m, 2)).astype(np.float32)
    mask = rng.random((N, m)) < 0.6
    ours = ref.slab_append(_t(pool), torch.from_numpy(owners), torch.from_numpy(bases),
                           torch.from_numpy(sizes), _t(elems), torch.from_numpy(mask))
    theirs = rref.slab_append(jnp.asarray(pool), jnp.asarray(owners), jnp.asarray(bases),
                              jnp.asarray(sizes), jnp.asarray(elems), jnp.asarray(mask))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("lengths", [[9, 2, 8, 1, 12], [1, 1, 1, 1, 1]])
@pytest.mark.parametrize("layout", ["flat", "extents"])
def test_paged_attend_plain_version_matches_reference(lengths, layout):
    """Float reduction: held to rtol = atol = 1e-5 (same f32 arithmetic in
    another order of summation)."""
    rng = np.random.default_rng(1)
    S, T, N, P, KH, G, D = 13, 4, 5, 3, 2, 3, 8
    pages = _fleet(rng, S, N, P, [3, 1, 2, 1, 3])
    kp = rng.standard_normal((S, T, KH, D)).astype(np.float32)
    vp = rng.standard_normal((S, T, KH, D)).astype(np.float32)
    q = rng.standard_normal((N, KH, G, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    if layout == "flat":
        kp_p, vp_p, kp_r, vp_r = _t(kp), _t(vp), jnp.asarray(kp), jnp.asarray(vp)
    else:
        kp_p, vp_p = tuple(_t(e) for e in _split(kp, (4,))), tuple(_t(e) for e in _split(vp, (4,)))
        kp_r = tuple(jnp.asarray(e) for e in _split(kp, (4,)))
        vp_r = tuple(jnp.asarray(e) for e in _split(vp, (4,)))
    ours = ops.paged_attend(_t(q), kp_p, vp_p, torch.from_numpy(pages), torch.from_numpy(lens))
    theirs = rops.paged_attend(jnp.asarray(q), kp_r, vp_r, jnp.asarray(pages), jnp.asarray(lens))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)


def test_knobs_are_checked_and_instrument_raises():
    pool = torch.zeros((2, 2))
    pages = torch.zeros((1, 1), dtype=torch.int32)
    for space in ("vmem", "hbm", None):
        ops.paged_gather(pool, pages, memory_space=space)
    with pytest.raises(ValueError):
        ops.paged_gather(pool, pages, memory_space="smem")
    # instrument=True (K15) adds the counter vector and leaves the data alone
    out, vec = ops.paged_gather(pool, pages, instrument=True)
    assert torch.equal(out, ops.paged_gather(pool, pages))
    assert vec.tolist()[5:8] == [1.0, 1.0, 0.0]  # launches, tiles, masked tiles
    args = (pool, torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), torch.ones((1, 1)), torch.ones((1, 1), dtype=torch.bool))
    for disp in ("auto", "onehot", "mxu"):
        ops.slab_append(*args, dispatch=disp)
    with pytest.raises(ValueError):
        ops.slab_append(*args, dispatch="gather")
    *_, vec = ops.slab_append(*args, instrument=True)
    assert vec.tolist()[16:] == [1.0, 1.0, 1.0]  # waves, lanes, active lanes


@pytest.mark.parametrize("kind", ["gather", "gather_extents", "append"])
def test_cuda_launchers_refuse_non_cuda_tensors(kind):
    """A tensor that is neither on the CPU nor on a card (``meta``) reaches
    the launchers and is refused, never run on the plain path."""
    meta = torch.device("meta")
    pool = torch.zeros((4, 2, 3), device=meta)
    pages = torch.zeros((2, 2), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="expected cuda"):
        if kind == "gather":
            ops.paged_gather(pool, pages)
        elif kind == "gather_extents":
            ops.paged_gather((pool, pool), pages)
        else:
            i32 = dict(dtype=torch.int32, device=meta)
            ops.slab_append(pool, torch.zeros(4, **i32), torch.zeros(4, **i32),
                            torch.zeros(2, **i32), torch.zeros((2, 3, 3), device=meta),
                            torch.ones((2, 3), dtype=torch.bool, device=meta))
    with pytest.raises(ValueError, match="expected cuda"):
        ops.paged_attend(torch.zeros((1, 1, 1, 2), device=meta), pool, pool, pages[:1],
                         torch.ones(1, dtype=torch.int32, device=meta))


def test_copy_unit_follows_sizes_and_addresses():
    base = torch.zeros(64, dtype=torch.uint8)
    assert common.copy_unit(32, base) == 16
    assert common.copy_unit(12, base) == 4
    assert common.copy_unit(6, base) == 2
    assert common.copy_unit(3, base) == 1
    assert common.copy_unit(32, base[4:]) == 4
    assert common.copy_unit(32, base[1:]) == 1


def test_to_device_passes_tensors_through_and_converts_host_data():
    cpu = torch.device("cpu")
    t = torch.arange(4)
    assert common.to_device(t, cpu) is t
    np.testing.assert_array_equal(common.to_device(np.asarray([[True, False]]), cpu).numpy(),
                                  [[True, False]])
    assert common.to_device([1.5, 2.0], cpu).dtype == torch.float32  # torch.as_tensor's rules


@pytest.mark.parametrize("layout", ["flat", "doubling", "tz"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attend_serving_cases_match_reference(layout, dtype):
    """K10/K11's plain version at serving-like cases — lengths of 0, inside
    a slab and at its end, an unclaimed (-1) page inside a live sequence,
    G = 8 query heads per KV head — against the reference's paged_attend
    (its Pallas kernels in interpret mode), within 2e-3 (f32 arithmetic in
    another order; bf16 pools are read exactly)."""
    from repro_torch.pool import extents as ext_mod

    rng = np.random.default_rng(3)
    T, KH, G, D = 4, 2, 8, 16
    lengths = [0, 3, 4, 9, 14]
    P = 4
    S = sum(-(-n // T) for n in lengths) + 2
    pages = _fleet(rng, S, len(lengths), P, [-(-n // T) for n in lengths])
    pages[4, 1] = -1
    kp = _data(rng, (S, T, KH, D), dtype)
    vp = _data(rng, (S, T, KH, D), dtype)
    q = rng.standard_normal((len(lengths), KH, G, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    if layout == "flat":
        cuts = ()
    else:
        sizes = ext_mod.plan_extents((), S, layout) if layout == "tz" else [2, 2, 4, 8, 16]
        cuts = tuple(int(c) for c in np.cumsum(sizes) if c < S)
    kparts, vparts = _split(kp, cuts), _split(vp, cuts)
    if len(kparts) == 1:
        kp_p, vp_p, kp_r, vp_r = _t(kp), _t(vp), jnp.asarray(kp), jnp.asarray(vp)
    else:
        kp_p, vp_p = tuple(_t(e) for e in kparts), tuple(_t(e) for e in vparts)
        kp_r, vp_r = tuple(jnp.asarray(e) for e in kparts), tuple(jnp.asarray(e) for e in vparts)
    ours = ops.paged_attend(_t(q), kp_p, vp_p, torch.from_numpy(pages), torch.from_numpy(lens))
    theirs = rops.paged_attend(jnp.asarray(q), kp_r, vp_r, jnp.asarray(pages), jnp.asarray(lens))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-3, atol=2e-3)
    assert np.all(ours.numpy()[0] == 0), "a sequence of length 0 reads zeros"
