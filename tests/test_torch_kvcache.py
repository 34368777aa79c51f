"""Port of the KV-cache policies (``repro.serving.kvcache``), ``ggarray`` and
``paged`` (one pool and extents): the same seeded K/V go through the
reference and the port.  Cache state — bucket levels, pools, page tables —
is held bitwise (it is data movement); attention, a float reduction, within
5e-4 (f32, another order of summation)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.serving import kvcache as rkv
from repro_torch import configs
from repro_torch.serving import kvcache as kv

ATOL = 5e-4


def _cfgs(**over):
    return rconfigs.reduced("qwen2.5-3b", **over), configs.reduced("qwen2.5-3b", **over)


def _to_port(cache):
    out = {}
    for k, v in cache.items():
        if isinstance(v, tuple):
            out[k] = tuple(torch.from_numpy(np.array(e)) for e in v)
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _assert_same_state(ours, theirs):
    assert set(ours) == set(theirs)
    for k in theirs:
        a, b = ours[k], theirs[k]
        if isinstance(b, tuple):
            assert isinstance(a, tuple) and len(a) == len(b), k
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=k)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)


def _split_pools(cache, cuts):
    out = dict(cache)
    for key in ("k_pool", "v_pool"):
        p = cache[key]
        edges = (0, *cuts, p.shape[0])
        out[key] = tuple(p[a:b] for a, b in zip(edges, edges[1:]))
    return out


def _kv(rng, B, n, KH, DH):
    return (rng.standard_normal((B, n, KH, DH)).astype(np.float32),
            rng.standard_normal((B, n, KH, DH)).astype(np.float32))


@pytest.mark.parametrize("policy,layout,impl", [
    ("ggarray", "flat", "levels"), ("paged", "flat", "levels"), ("paged", "flat", "pallas"),
    ("paged", "extents", "levels"), ("paged", "extents", "pallas"),
])
def test_fill_append_attend_match_reference(policy, layout, impl):
    rcfg, cfg = _cfgs(cache_b0=4, paged_attend_impl=impl)
    B, KH, DH, H = 3, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    rng = np.random.default_rng(5)
    n = 21
    ks, vs = _kv(rng, B, n, KH, DH)
    q = rng.standard_normal((B, 1, H, DH)).astype(np.float32)
    lengths = np.asarray([n, 6, 1], np.int32)
    theirs = rkv.init_cache(rcfg, B, n, policy, dtype=jnp.float32)
    ours = kv.init_cache(cfg, B, n, policy, dtype=torch.float32, device="cpu")
    _assert_same_state(ours, theirs)
    if layout == "extents":
        theirs, ours = _split_pools(theirs, (5, 7)), _split_pools(ours, (5, 7))
    theirs = rkv.fill_from_prefill(theirs, jnp.asarray(ks[:, :10]), jnp.asarray(vs[:, :10]))
    ours = kv.fill_from_prefill(ours, torch.from_numpy(ks[:, :10]), torch.from_numpy(vs[:, :10]))
    _assert_same_state(ours, theirs)
    for t in range(10, n):
        theirs = rkv.append(theirs, jnp.asarray(ks[:, t:t + 1]), jnp.asarray(vs[:, t:t + 1]), jnp.int32(t), rcfg)
        ours = kv.append(ours, torch.from_numpy(ks[:, t:t + 1]), torch.from_numpy(vs[:, t:t + 1]), t, cfg)
        _assert_same_state(ours, theirs)
    got = kv.attend(ours, torch.from_numpy(q), torch.from_numpy(lengths), cfg)
    want = rkv.attend(theirs, jnp.asarray(q), jnp.asarray(lengths), rcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)
    assert kv.capacity_of(ours) == rkv.capacity_of(theirs)
    assert kv.cache_bytes(ours) == rkv.cache_bytes(theirs)


def test_paged_append_drops_unclaimed_pages_and_positions_past_the_table():
    rcfg, cfg = _cfgs(cache_b0=4)
    rng = np.random.default_rng(6)
    B, KH, DH = 3, cfg.n_kv_heads, cfg.head_dim
    theirs = rkv.init_cache(rcfg, B, 8, "paged", dtype=jnp.float32)
    theirs["pages"] = theirs["pages"].at[1, 1].set(-1)
    ours = _to_port(theirs)
    k, v = _kv(rng, B, 1, KH, DH)
    pos = np.asarray([7, 5, 8], np.int32)  # row 1 → unclaimed page, row 2 → past the table
    theirs = rkv.append(theirs, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    ours = kv.append(ours, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos))
    _assert_same_state(ours, theirs)


@pytest.mark.parametrize("levels", [1, 2])
def test_grow_ggarray_matches_reference(levels):
    rcfg, cfg = _cfgs(cache_b0=4)
    rng = np.random.default_rng(7)
    ks, vs = _kv(rng, 2, 9, cfg.n_kv_heads, cfg.head_dim)
    theirs = rkv.fill_from_prefill(rkv.init_cache(rcfg, 2, 9, "ggarray", dtype=jnp.float32),
                                   jnp.asarray(ks), jnp.asarray(vs))
    ours = kv.fill_from_prefill(
        kv.init_cache(cfg, 2, 9, "ggarray", dtype=torch.float32, device="cpu"),
        torch.from_numpy(ks), torch.from_numpy(vs))
    before = dict(ours)
    theirs, ours = rkv.grow_ggarray(theirs, rcfg, levels), kv.grow_ggarray(ours, cfg, levels)
    _assert_same_state(ours, theirs)
    assert all(ours[k] is before[k] for k in before), "growth must not copy the old levels"
    assert kv.capacity_of(ours) == rkv.capacity_of(theirs)
    assert kv.cache_bytes(ours) == rkv.cache_bytes(theirs)


@pytest.mark.parametrize("policy,hint", [("ggarray", 1), ("ggarray", 13), ("paged", 1), ("paged", 13)])
def test_capacity_matches_reference(policy, hint):
    rcfg, cfg = _cfgs(cache_b0=4, cache_slab=3)
    assert kv.cache_capacity(cfg, policy, hint) == rkv.cache_capacity(rcfg, policy, hint)
    assert kv.capacity_of(kv.init_cache(cfg, 2, hint, policy, device="cpu")) == rkv.capacity_of(
        rkv.init_cache(rcfg, 2, hint, policy))
    stacked = kv.init_cache(cfg, 2, hint, policy, stack=3, device="cpu")
    rstacked = rkv.init_cache(rcfg, 2, hint, policy, stack=3)
    _assert_same_state(stacked, rstacked)
    view = kv.period_view(stacked, 1)
    assert all(v.data_ptr() == stacked[k][1].data_ptr() for k, v in view.items())


@pytest.mark.parametrize("layout", ["flat", "extents"])
@pytest.mark.parametrize("t0,live,width", [(0, 6, 8), (8, 8, 8), (13, 3, 4), (4, 8, 8)])
def test_chunk_attend_and_scatter_chunk_match_reference(layout, t0, live, width):
    """The chunked-prefill attention of one slot over its claimed slabs, and
    the scatter of the chunk into them."""
    rcfg, cfg = _cfgs(cache_b0=4, attention_chunk=4)
    rng = np.random.default_rng(t0 * 10 + live)
    KH, DH, H, T = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, 4
    S, maxp = 9, 6
    pool_k = rng.standard_normal((S, T, KH, DH)).astype(np.float32)
    pool_v = rng.standard_normal((S, T, KH, DH)).astype(np.float32)
    row = np.full((maxp,), -1, np.int32)
    row[: -(-(t0 + live) // T)] = rng.permutation(S)[: -(-(t0 + live) // T)]
    theirs = {"k_pool": jnp.asarray(pool_k), "v_pool": jnp.asarray(pool_v),
              "pages": jnp.asarray(np.full((1, maxp), -1, np.int32))}
    if layout == "extents":
        theirs = _split_pools(theirs, (2, 5))
    ours = _to_port(theirs)
    q = rng.standard_normal((1, width, H, DH)).astype(np.float32)
    k, v = _kv(rng, 1, width, KH, DH)
    got = kv.chunk_attend(ours, torch.from_numpy(row), torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), t0, live, cfg, first=t0 == 0)
    want = rkv.chunk_attend(theirs, jnp.asarray(row), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.int32(t0), jnp.int32(live), rcfg, first=t0 == 0)
    np.testing.assert_allclose(got[0, :live].numpy(), np.asarray(want)[0, :live], rtol=ATOL, atol=ATOL)
    kv.scatter_chunk(ours, torch.from_numpy(row), torch.from_numpy(k), torch.from_numpy(v), t0, live, cfg)
    theirs = rkv.scatter_chunk(theirs, jnp.asarray(row), jnp.asarray(k), jnp.asarray(v),
                               jnp.int32(t0), jnp.int32(live), rcfg)
    _assert_same_state(ours, theirs)


@pytest.mark.parametrize("layout", ["flat", "extents"])
@pytest.mark.parametrize("axis", [0, 1])
def test_copy_slab_matches_reference(layout, axis):
    rng = np.random.default_rng(8)
    shape = (7, 3, 2) if axis == 0 else (2, 7, 3)
    pool = rng.standard_normal(shape).astype(np.float32)
    if layout == "flat":
        theirs, ours = jnp.asarray(pool), torch.from_numpy(pool.copy())
    else:
        parts = np.split(pool, [2, 5], axis=axis)
        theirs = tuple(jnp.asarray(p) for p in parts)
        ours = tuple(torch.from_numpy(p.copy()) for p in parts)
    for src, dst in ((1, 6), (5, 0), (3, 4)):
        theirs = rkv.copy_slab(theirs, src, dst, axis=axis)
        ours = kv.copy_slab(ours, src, dst, axis=axis)
    for a, b in zip(ours if isinstance(ours, tuple) else (ours,),
                    theirs if isinstance(theirs, tuple) else (theirs,)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(IndexError):
        kv.copy_slab(ours, 7, 0, axis=axis)


@pytest.mark.parametrize("what", ["static", "semistatic", "two_phase", "quant"])
def test_policies_and_int8_caches_build_the_reference_cache(what):
    """The static, semistatic and two_phase policies and the int8 cache
    (``cache_quant``, here a ggarray one: int8 levels with bf16 scale
    levels) build the reference's cache: the same keys, shapes and dtypes."""
    rcfg, cfg = _cfgs(cache_quant=what == "quant")
    policy = "ggarray" if what == "quant" else what
    ours, theirs = kv.init_cache(cfg, 2, 11, policy, device="cpu"), rkv.init_cache(rcfg, 2, 11, policy)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in theirs.items()}
    assert {k: str(v.dtype).split(".")[-1] for k, v in ours.items()} == {
        k: np.asarray(v).dtype.name for k, v in theirs.items()}
    assert kv.capacity_of(ours) == rkv.capacity_of(theirs) == kv.cache_capacity(cfg, policy, 11)
