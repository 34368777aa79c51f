"""Port of the int8 KV cache (``cfg.cache_quant``, ``repro.serving.kvcache``):
int8 codes with one bf16 scale per (token, kv head), beside the static
buffer, each ggarray level and the paged pools.  The same seeded K/V go
through the reference and the port, as in ``tests/serving/
test_quant_cache.py``:

* the quantiser's codes and scales, and every cache state (levels, pools,
  scale pools, page tables) after fills, appends and chunk scatters, are
  held **bitwise** (they are the reference's arithmetic and data movement);
* attention over the dequantised cache, a float reduction, within 1e-5;
* the engines' greedy tokens token for token, on ``reduced("qwen2.5-3b",
  cache_b0=4)`` with the reference's own parameters."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import transformer as rtf
from repro.serving import kvcache as rkv
from repro.serving.engine import BatchEngine as RBatchEngine
from repro.serving.engine import Engine as REngine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.serving import kvcache as kv
from repro_torch.serving.engine import BatchEngine, Engine

TOL = 1e-5  # attention over the same dequantised K/V, another order of summation


def _cfgs(arch="qwen3-32b", **over):
    over = {"cache_b0": 4, **over}
    return (dataclasses.replace(rconfigs.reduced(arch, **over), cache_quant=True),
            dataclasses.replace(configs.reduced(arch, **over), cache_quant=True))


def _bits(x) -> np.ndarray:
    a = x.float().numpy() if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 else None
    if a is not None:  # bf16 → its 16 bits, through f32 (exact)
        return a.view(np.uint32) >> 16
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32).view(np.uint32) >> 16
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same_state(ours, theirs):
    assert set(ours) == set(theirs)
    for key in theirs:
        a, b = ours[key], theirs[key]
        pairs = zip(a, b) if isinstance(b, tuple) else [(a, b)]
        if isinstance(b, tuple):
            assert isinstance(a, tuple) and len(a) == len(b), key
        for x, y in pairs:
            assert x.dtype == {"int8": torch.int8, "bfloat16": torch.bfloat16, "int32": torch.int32,
                               "float32": torch.float32}[np.asarray(y).dtype.name], key
            np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=key)


def _kv(rng, B, n, KH, DH):
    return (rng.standard_normal((B, n, KH, DH)).astype(np.float32),
            rng.standard_normal((B, n, KH, DH)).astype(np.float32))


def _split_pools(cache, cuts):
    out = dict(cache)
    for key in ("k_pool", "v_pool", "ks_pool", "vs_pool"):
        p = cache[key]
        edges = (0, *cuts, p.shape[0])
        out[key] = tuple(p[a:b] for a, b in zip(edges, edges[1:]))
    return out


def _to_port(cache):
    def one(v):
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return {k: tuple(one(e) for e in v) if isinstance(v, tuple) else one(v) for k, v in cache.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizer_codes_and_scales_are_bitwise_the_reference(dtype):
    """Random rows at several magnitudes, an all-zero row (the 1e-8 floor)
    and a row of exact ties (scale 1: 0.5, 1.5, 2.5, -2.5 round half to
    even)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 37, 4, 16)).astype(np.float32)
    x *= np.asarray([1e-3, 1.0, 300.0], np.float32)[:, None, None, None]
    x[0, 0] = 0.0
    x[1, 1, 0, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]
    x[1, 1, 0, 6:] = 0.0
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    want_q, want_s = rkv._quantize_kv(xj)
    got_q, got_s = kv._quantize_kv(xt)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(_bits(got_s), _bits(want_s))
    assert got_q[1, 1, 0, :6].tolist() == [127, 0, 2, 2, -2, 0]
    np.testing.assert_array_equal(kv._dequant(got_q, got_s).numpy(),
                                  np.asarray(rkv._dequant(want_q, want_s)))


@pytest.mark.parametrize("policy,layout,kh", [
    ("static", "flat", 1), ("semistatic", "flat", 2), ("ggarray", "flat", 1), ("ggarray", "flat", 2),
    ("paged", "flat", 2), ("paged", "extents", 1),
])
def test_fill_append_attend_match_reference(policy, layout, kh):
    """fill_from_prefill then decode appends: codes, scales, levels, pools
    and page tables bitwise after every step; attention within 1e-5 (the
    paged walk under ``"pallas"`` too: an int8 cache never takes K10/K11)."""
    rcfg, cfg = _cfgs(n_kv_heads=kh, paged_attend_impl="pallas")
    B, KH, DH, H = 3, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    rng = np.random.default_rng(5 + kh)
    n = 21
    ks, vs = _kv(rng, B, n, KH, DH)
    q = rng.standard_normal((B, 1, H, DH)).astype(np.float32)
    lengths = np.asarray([n, 6, 1], np.int32)
    theirs = rkv.init_cache(rcfg, B, n, policy)
    ours = kv.init_cache(cfg, B, n, policy, device="cpu")
    _same_state(ours, theirs)
    if layout == "extents":
        theirs, ours = _split_pools(theirs, (5, 7)), _split_pools(ours, (5, 7))
    theirs = rkv.fill_from_prefill(theirs, jnp.asarray(ks[:, :10]), jnp.asarray(vs[:, :10]))
    ours = kv.fill_from_prefill(ours, torch.from_numpy(ks[:, :10]), torch.from_numpy(vs[:, :10]))
    _same_state(ours, theirs)
    for t in range(10, n):
        theirs = rkv.append(theirs, jnp.asarray(ks[:, t:t + 1]), jnp.asarray(vs[:, t:t + 1]),
                            jnp.int32(t), rcfg)
        ours = kv.append(ours, torch.from_numpy(ks[:, t:t + 1]), torch.from_numpy(vs[:, t:t + 1]), t, cfg)
        _same_state(ours, theirs)
    got = kv.attend(ours, torch.from_numpy(q), torch.from_numpy(lengths), cfg)
    want = rkv.attend(theirs, jnp.asarray(q), jnp.asarray(lengths), rcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert kv.cache_bytes(ours) == rkv.cache_bytes(theirs)


@pytest.mark.parametrize("layout", ["flat", "extents"])
@pytest.mark.parametrize("t0,live,width", [(0, 6, 8), (8, 8, 8), (13, 3, 4), (4, 8, 8)])
def test_chunk_attend_and_scatter_chunk_match_reference(layout, t0, live, width):
    """Chunked prefill over an int8 paged slot: the prefix is dequantised
    (the chunk attends its own K/V unquantised), the chunk's codes and
    scales land in the claimed slabs bitwise."""
    rcfg, cfg = _cfgs(arch="qwen2.5-3b", attention_chunk=4)
    rng = np.random.default_rng(t0 * 10 + live)
    KH, DH, H, T = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, 4
    S, maxp = 9, 6
    kq, ksc = rkv._quantize_kv(jnp.asarray(rng.standard_normal((S, T, KH, DH)), jnp.float32))
    vq, vsc = rkv._quantize_kv(jnp.asarray(rng.standard_normal((S, T, KH, DH)), jnp.float32))
    row = np.full((maxp,), -1, np.int32)
    row[: -(-(t0 + live) // T)] = rng.permutation(S)[: -(-(t0 + live) // T)]
    theirs = {"k_pool": kq, "v_pool": vq, "ks_pool": ksc, "vs_pool": vsc,
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
    np.testing.assert_allclose(got[0, :live].numpy(), np.asarray(want)[0, :live], rtol=TOL, atol=TOL)
    kv.scatter_chunk(ours, torch.from_numpy(row), torch.from_numpy(k), torch.from_numpy(v), t0, live, cfg)
    theirs = rkv.scatter_chunk(theirs, jnp.asarray(row), jnp.asarray(k), jnp.asarray(v),
                               jnp.int32(t0), jnp.int32(live), rcfg)
    _same_state(ours, theirs)


def test_quant_append_path_matches_fill_path():
    """The reference test's claim, on the port: one token at a time through
    the four-group push-back stores what one fill stores, bit for bit, so
    attention agrees (here exactly)."""
    _, cfg = _cfgs()
    B, KH, DH, H = 2, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    rng = np.random.default_rng(1)
    n = 9
    ks, vs = (torch.from_numpy(a) for a in _kv(rng, B, n, KH, DH))
    q = torch.from_numpy(rng.standard_normal((B, 1, H, DH)).astype(np.float32))
    filled = kv.fill_from_prefill(kv.init_cache(cfg, B, 32, "ggarray", device="cpu"), ks, vs)
    stepped = kv.init_cache(cfg, B, 32, "ggarray", device="cpu")
    for t in range(n):
        kv.append(stepped, ks[:, t:t + 1], vs[:, t:t + 1], t)
    for key in filled:
        assert torch.equal(filled[key], stepped[key]), key
    assert torch.equal(kv.attend(filled, q, n, cfg), kv.attend(stepped, q, n, cfg))


def test_quant_halves_cache_bytes():
    """int8 codes and bf16 scales against bf16 K/V: (Dh + 2) / 2 Dh (0.508
    at qwen2.5-3b's Dh = 128, 0.5625 at this config's 16), < 0.6 as the
    reference asserts, and the bytes the reference's."""
    plain = dict(cache_b0=64, dtype="bfloat16")
    exact = kv.init_cache(configs.reduced("qwen3-32b", **plain), 2, 256, "ggarray", device="cpu")
    rcfg, cfg = _cfgs(cache_b0=64)
    quant = kv.init_cache(cfg, 2, 256, "ggarray", device="cpu")
    ratio = kv.cache_bytes(quant) / kv.cache_bytes(exact)
    dh = cfg.head_dim
    assert ratio == (dh + 2) / (2 * dh) < 0.6
    assert kv.cache_bytes(quant) == rkv.cache_bytes(rkv.init_cache(rcfg, 2, 256, "ggarray"))


def test_growth_adds_scale_levels_and_freeze_thaw_carry_them():
    """Growth adds the next scale levels copy-free; freeze concatenates the
    scales along their own sequence axis and thaw slices them back, all
    bitwise the reference's."""
    rcfg, cfg = _cfgs()
    rng = np.random.default_rng(3)
    ks, vs = _kv(rng, 2, 7, cfg.n_kv_heads, cfg.head_dim)
    theirs = rkv.fill_from_prefill(rkv.init_cache(rcfg, 2, 8, "ggarray"), jnp.asarray(ks), jnp.asarray(vs))
    ours = kv.fill_from_prefill(kv.init_cache(cfg, 2, 8, "ggarray", device="cpu"),
                                torch.from_numpy(ks), torch.from_numpy(vs))
    before = dict(ours)
    theirs, ours = rkv.grow_ggarray(theirs, rcfg), kv.grow_ggarray(ours, cfg)
    lv = kv._levels(ours)
    assert f"ks{lv - 1}" in ours and f"vs{lv - 1}" in ours
    assert all(ours[key] is before[key] for key in before), "growth must not copy"
    _same_state(ours, theirs)
    frozen, rfrozen = kv.freeze_cache(ours), rkv.freeze_cache(theirs)
    _same_state(frozen, rfrozen)
    assert set(frozen) == {"k", "v", "ks", "vs"}
    _same_state(kv.thaw_cache(frozen, cfg.cache_b0), rkv.thaw_cache(rfrozen, rcfg.cache_b0))


# ---------------------------------------------------------------- engines
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [11], [12, 13]]


@pytest.fixture(scope="module")
def model():
    rcfg, cfg = _cfgs(arch="qwen2.5-3b")
    rparams = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rparams, params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")


@pytest.mark.parametrize("policy", ["ggarray", "static", "two_phase"])
def test_engine_tokens_match_reference(model, policy):
    """``Engine`` under an int8 cache, token for token; the growing policies
    grow once (8 new tokens past a 4-token first level)."""
    rcfg, cfg, rparams, params = model
    want = REngine(rparams, rcfg, policy=policy, max_len=32).generate(PROMPTS, 8)
    eng = Engine(params, cfg, policy=policy, max_len=32, device="cpu")
    assert eng.generate(PROMPTS, 8) == want
    slot = eng.caches[0]
    assert all(slot[key].dtype == torch.int8 for key in slot if key[:1] in "kv" and key[1:2] != "s")
    assert all(slot[key].dtype == torch.bfloat16 for key in slot if key[1:2] == "s")
    if policy != "static":
        assert eng.stats.grow_events >= 1


def test_engine_semistatic_grows_the_scales_too(model):
    """Before a growth, semistatic matches the reference's semistatic token
    for token.  The reference's realloc copies k and v but leaves the
    scales at the old capacity, so its first step after a growth fails
    (ROADMAP.md Queue 3); the port grows the scales with them and is held
    there to the reference's ggarray run, token for token."""
    rcfg, cfg, rparams, params = model
    short = [p[:2] for p in PROMPTS]
    want = REngine(rparams, rcfg, policy="semistatic").generate(short, 2)
    assert Engine(params, cfg, policy="semistatic", device="cpu").generate(short, 2) == want
    eng = Engine(params, cfg, policy="semistatic", device="cpu")
    got = eng.generate(PROMPTS, 8)
    assert eng.stats.grow_events >= 1
    c = eng.caches[0]
    assert c["ks"].shape[-2] == c["k"].shape[-3] == c["vs"].shape[-2]
    assert got == REngine(rparams, rcfg, policy="ggarray").generate(PROMPTS, 8)


@pytest.mark.parametrize("grow_chunk", [1, "doubling"])
def test_batch_engine_quant_pools_are_int8_and_tokens_match(model, grow_chunk):
    """``BatchEngine`` over int8 pools (four pools a layer, flat or
    extents), chunked admission across chunk boundaries: tokens, page
    tables and the allocator equal to the reference's."""
    rcfg, cfg, rparams, params = model
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(1, 50, L)] for L in (33, 6, 9)]  # 2, 1, 1 chunks
    ref = RBatchEngine(rparams, rcfg, max_batch=2, grow_chunk=grow_chunk)
    want = ref.run_all(prompts, 5)
    be = BatchEngine(params, cfg, max_batch=2, grow_chunk=grow_chunk, device="cpu")
    for c in be._attn_slots():
        for key in ("k_pool", "v_pool", "ks_pool", "vs_pool"):
            exts = c[key] if isinstance(c[key], tuple) else (c[key],)
            assert all(e.dtype == (torch.bfloat16 if "s_" in key else torch.int8) for e in exts)
    assert be.run_all(prompts, 5) == want
    be.check_free_list()
    np.testing.assert_array_equal(be.alloc.refcount, ref.alloc.refcount)
    np.testing.assert_array_equal(be.caches[0]["pages"].numpy(), np.asarray(ref.caches[0]["pages"]))
    assert (be.stats.pool_copied_bytes == 0) == (grow_chunk == "doubling")


def test_batch_engine_quant_matches_the_quantised_engine(model):
    """The reference test (``test_batch_engine.py:144``) on the port: the
    paged int8 cache decodes the quantised ggarray ``Engine``'s tokens."""
    _, cfg, _, params = model
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10]]
    want = Engine(params, cfg, policy="ggarray", max_len=64, device="cpu").generate(prompts, 5)
    be = BatchEngine(params, cfg, max_batch=2, device="cpu")
    assert be.run_all(prompts, 5) == want
    be.check_free_list()


def test_init_decode_caches_match_reference():
    """``steps.init_decode_caches`` under ``cache_quant``: the period-stacked
    int8 caches with bf16 scales the reference's make, key for key."""
    from repro.serving import steps as rsteps
    from repro_torch.serving import steps

    for policy in ("ggarray", "static", "paged"):
        rcfg, cfg = _cfgs(arch="qwen2.5-3b")
        ours = steps.init_decode_caches(cfg, 2, 9, policy=policy, device="cpu")
        theirs = rsteps.init_decode_caches(rcfg, 2, 9, policy=policy)
        for a, b in zip(ours, theirs):
            _same_state(a, b)
