"""Port of the static, semi-static and two-phase KV-cache policies
(``repro.serving.kvcache`` ``freeze_cache``/``thaw_cache``, the static
``init_cache``/``fill_from_prefill``/``append``/``attend``, and
``Engine(policy=...)``), mirroring ``tests/serving/test_two_phase_cache.py``,
the static/semistatic cases of ``test_steps_engine.py`` and
``test_policy_property.py``, held against the reference on the same seeded
inputs:

* cache state (levels, frozen and thawed buffers) bitwise, f32 and bf16;
* attention within 5e-4 of the reference (f32, another summation order)
  and the policies within 3e-5 of each other, as the reference holds them.
  The reference also holds the paged walk bitwise equal to the ggarray walk;
  that rests on XLA summing a 4-key and an 8-key segment alike, and torch's
  matmul does not (one ulp apart), so the port holds it within 3e-5 too;
* ``Engine`` token for token, with equal grow/freeze events and allocated
  and copied bytes, on ``reduced("qwen2.5-3b", cache_b0=8)``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:
    from _hypothesis_fallback import given, settings, st

from repro import configs as rconfigs
from repro.models import transformer as rtf
from repro.serving import kvcache as rkv
from repro.serving import steps as rsteps
from repro.serving.engine import Engine as REngine
from repro_torch import configs, convert
from repro_torch.serving import kvcache as kv
from repro_torch.serving import steps
from repro_torch.serving.engine import Engine

ATOL = 5e-4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch="qwen3-32b", **over):
    return rconfigs.reduced(arch, **over), configs.reduced(arch, **over)


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_same_cache(ours: dict, theirs: dict):
    mine = convert.cache_to_numpy(ours)
    assert set(mine) == set(theirs)
    for key in theirs:
        np.testing.assert_array_equal(_bits(mine[key]), _bits(theirs[key]), err_msg=key)


def _filled_ggarray_pair(rcfg, cfg, dtype, B=2, steps=13, seed=0):
    """The same ggarray cache in both packages, filled by decode appends."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    theirs = rkv.init_cache(rcfg, B, steps + 4, "ggarray", dtype=jdt)
    ours = kv.init_cache(cfg, B, steps + 4, "ggarray", dtype=tdt, device="cpu")
    shp = (B, 1, cfg.n_kv_heads, cfg.head_dim)
    for t in range(steps):
        k = jnp.asarray(rng.standard_normal(shp), jdt)
        v = jnp.asarray(rng.standard_normal(shp), jdt)
        theirs = rkv.append(theirs, k, v, t)
        kv.append(ours, convert.tensor_from_numpy(np.asarray(k), "cpu"),
                  convert.tensor_from_numpy(np.asarray(v), "cpu"), t)
    _assert_same_cache(ours, theirs)
    return ours, theirs


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_freeze_thaw_round_trip_and_attend_parity(dtype):
    rcfg, cfg = _cfgs(cache_b0=4)
    steps_ = 13
    ours, theirs = _filled_ggarray_pair(rcfg, cfg, dtype, steps=steps_, seed=1)
    rng = np.random.default_rng(2)
    q = jnp.asarray(rng.standard_normal((2, 1, cfg.n_heads, cfg.head_dim)), DTYPES[dtype][0])
    tq = convert.tensor_from_numpy(np.asarray(q), "cpu")
    a_gg = kv.attend(ours, tq, steps_, cfg)

    frozen, rfrozen = kv.freeze_cache(ours), rkv.freeze_cache(theirs)
    assert "k" in frozen and "k0" not in frozen
    _assert_same_cache(frozen, rfrozen)
    a_frozen = kv.attend(frozen, tq, steps_, cfg)
    tol = 2e-5 if dtype == "float32" else 1e-2  # bf16 output rounding
    np.testing.assert_allclose(a_gg.float().numpy(), a_frozen.float().numpy(), rtol=tol, atol=tol)
    want = rkv.attend(rfrozen, q, steps_, rcfg)
    tol = ATOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(a_frozen.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)

    thawed, rthawed = kv.thaw_cache(frozen, cfg.cache_b0), rkv.thaw_cache(rfrozen, rcfg.cache_b0)
    assert set(thawed) == set(ours)
    _assert_same_cache(thawed, rthawed)
    _assert_same_cache(thawed, {k: np.asarray(v) for k, v in theirs.items()})
    assert all(t.is_contiguous() for t in thawed.values())


def test_freeze_preserves_passthrough_keys_and_is_idempotent():
    rcfg, cfg = _cfgs(cache_b0=4)
    ours, _ = _filled_ggarray_pair(rcfg, cfg, "float32", steps=5)
    cross = torch.ones((2, 7, cfg.n_kv_heads, cfg.head_dim))
    frozen = kv.freeze_cache(dict(ours, cross_k=cross, cross_v=cross))
    assert frozen["cross_k"] is cross
    assert set(kv.freeze_cache(frozen)) == set(frozen)
    assert kv.thaw_cache(ours, 4).keys() == ours.keys()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_frozen_decode_appends_until_capacity_then_drops(dtype):
    rcfg, cfg = _cfgs(cache_b0=4)
    ours, theirs = _filled_ggarray_pair(rcfg, cfg, dtype, steps=5, seed=3)
    frozen, rfrozen = kv.freeze_cache(ours), rkv.freeze_cache(theirs)
    cap = kv.capacity_of(frozen)
    assert cap == rkv.capacity_of(rfrozen) and cap >= 6
    rng = np.random.default_rng(4)
    shp = (2, 1, cfg.n_kv_heads, cfg.head_dim)
    for pos in (5, cap - 1, cap, cap + 3):  # the last two lie past the buffer: dropped
        k = jnp.asarray(rng.standard_normal(shp), DTYPES[dtype][0])
        v = jnp.asarray(rng.standard_normal(shp), DTYPES[dtype][0])
        rfrozen = rkv.append(rfrozen, k, v, pos)
        assert kv.append(frozen, convert.tensor_from_numpy(np.asarray(k), "cpu"),
                         convert.tensor_from_numpy(np.asarray(v), "cpu"), pos) is frozen
        _assert_same_cache(frozen, rfrozen)
    np.testing.assert_array_equal(_bits(convert.tensor_to_numpy(frozen["k"][:, 5])),
                                  _bits(np.asarray(rfrozen["k"][:, 5])))


@pytest.mark.parametrize("policy", ["static", "semistatic"])
@pytest.mark.parametrize("hint", [5, 8, 19])
def test_static_caches_init_fill_append_attend_match_reference(policy, hint):
    rcfg, cfg = _cfgs(cache_b0=4)
    assert kv.cache_capacity(cfg, policy, hint) == rkv.cache_capacity(rcfg, policy, hint)
    B, S = 3, min(hint, 6)
    rng = np.random.default_rng(hint)
    shp = (B, S, cfg.n_kv_heads, cfg.head_dim)
    kf, vf = (rng.standard_normal(shp).astype(np.float32) for _ in range(2))
    theirs = rkv.fill_from_prefill(rkv.init_cache(rcfg, B, hint, policy), jnp.asarray(kf),
                                   jnp.asarray(vf))
    ours = kv.fill_from_prefill(kv.init_cache(cfg, B, hint, policy, device="cpu"),
                                torch.from_numpy(kf), torch.from_numpy(vf))
    _assert_same_cache(ours, theirs)
    assert kv.capacity_of(ours) == rkv.capacity_of(theirs)
    lengths = np.asarray([S, S - 1, 1], np.int32)
    for t in range(4):
        k1, v1 = (rng.standard_normal((B, 1) + shp[2:]).astype(np.float32) for _ in range(2))
        theirs = rkv.append(theirs, jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(lengths))
        kv.append(ours, torch.from_numpy(k1), torch.from_numpy(v1), torch.from_numpy(lengths))
        lengths = lengths + 1
        _assert_same_cache(ours, theirs)
        q = rng.standard_normal((B, 1, cfg.n_heads, cfg.head_dim)).astype(np.float32)
        want = rkv.attend(theirs, jnp.asarray(q), jnp.asarray(lengths), rcfg)
        got = kv.attend(ours, torch.from_numpy(q), torch.from_numpy(lengths), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)
    assert kv.cache_bytes(ours) == rkv.cache_bytes(theirs)


def _policies_over_trace(n, seed):
    rcfg, cfg = _cfgs(cache_b0=4)
    B, KH, DH, H = 2, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    rng = np.random.default_rng(seed)
    ks = rng.standard_normal((B, n, KH, DH)).astype(np.float32)
    vs = rng.standard_normal((B, n, KH, DH)).astype(np.float32)
    q = rng.standard_normal((B, 1, H, DH)).astype(np.float32)
    lengths = rng.integers(1, n + 1, B).astype(np.int32)
    split = int(rng.integers(0, n + 1))  # bulk prefill, then per-step appends
    outs = {}
    for policy in ("static", "semistatic", "ggarray", "paged"):
        cache = kv.init_cache(cfg, B, max(n, 8), policy, dtype=torch.float32, device="cpu")
        kv.fill_from_prefill(cache, torch.from_numpy(ks[:, :split]), torch.from_numpy(vs[:, :split]))
        for t in range(split, n):
            kv.append(cache, torch.from_numpy(ks[:, t:t + 1]), torch.from_numpy(vs[:, t:t + 1]), t)
        outs[policy] = kv.attend(cache, torch.from_numpy(q), torch.from_numpy(lengths), cfg).numpy()
    np.testing.assert_allclose(outs["static"], outs["ggarray"], rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(outs["static"], outs["semistatic"], rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(outs["paged"], outs["ggarray"], rtol=3e-5, atol=3e-5)
    ref = rkv.init_cache(rcfg, B, max(n, 8), "static", dtype=jnp.float32)
    ref = rkv.fill_from_prefill(ref, jnp.asarray(ks[:, :split]), jnp.asarray(vs[:, :split]))
    for t in range(split, n):
        ref = rkv.append(ref, jnp.asarray(ks[:, t:t + 1]), jnp.asarray(vs[:, t:t + 1]), jnp.int32(t))
    want = rkv.attend(ref, jnp.asarray(q), jnp.asarray(lengths), rcfg)
    np.testing.assert_allclose(outs["static"], np.asarray(want), rtol=ATOL, atol=ATOL)


@given(st.integers(1, 30), st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_policies_equivalent_over_random_traces(n, seed):
    _policies_over_trace(n, seed)


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 1), (13, 2), (30, 3)])
def test_policies_equivalent_over_seeded_traces(n, seed):
    _policies_over_trace(n, seed)


@pytest.fixture(scope="module")
def model():
    rcfg = rconfigs.reduced("qwen2.5-3b", cache_b0=8)
    cfg = configs.reduced("qwen2.5-3b", cache_b0=8)
    rparams = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rparams, convert.params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")


@pytest.mark.parametrize("policy", ["static", "semistatic", "ggarray"])
def test_decode_policies_match_reference_logits(model, policy):
    rcfg, cfg, rparams, params = model
    B, S = 2, 12
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    _, rc = rsteps.prefill(rparams, jnp.asarray(toks[:, :S]), rcfg, capacity_hint=S + 2,
                           policy=policy)
    want, _ = rsteps.decode_step(rparams, jnp.asarray(toks[:, S]), rc, jnp.int32(S), rcfg)
    _, caches = steps.prefill(params, torch.from_numpy(toks[:, :S]), cfg, capacity_hint=S + 2,
                              policy=policy)
    got, _ = steps.decode_step(params, torch.from_numpy(toks[:, S]), caches,
                               torch.tensor(S, dtype=torch.int32), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)


ENGINE_PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11]]
ENGINE_NEW = 14  # the longest context crosses cache_b0 = 8 and then 24


@pytest.mark.parametrize("policy", ["static", "semistatic", "two_phase"])
def test_engine_policy_matches_reference_token_for_token(model, policy):
    rcfg, cfg, rparams, params = model
    reng = REngine(rparams, rcfg, policy=policy, max_len=32)
    want = reng.generate(ENGINE_PROMPTS, ENGINE_NEW, temperature=0.0)
    eng = Engine(params, cfg, policy=policy, max_len=32, device="cpu")
    assert eng.generate(ENGINE_PROMPTS, ENGINE_NEW) == want
    ours, theirs = eng.stats, reng.stats
    for name in ("grow_events", "freeze_events", "copied_bytes", "allocated_bytes", "decode_steps"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.host_syncs == 1
    if policy == "static":
        assert ours.grow_events == 0 and ours.copied_bytes == 0
    else:
        assert ours.grow_events >= 1 and ours.copied_bytes > 0
    if policy == "two_phase":
        assert ours.freeze_events == ours.grow_events + 1  # the prefill handoff + each refreeze
        assert all("k" in c and "k0" not in c for c in eng.caches)


def test_engine_rejects_unknown_policies(model):
    _, cfg, _, params = model
    with pytest.raises(ValueError, match="policy"):
        Engine(params, cfg, policy="bogus", device="cpu")
    with pytest.raises(ValueError, match="policy"):
        kv.init_cache(cfg, 1, 4, "bogus", device="cpu")


def test_cache_numpy_round_trip_carries_bf16():
    _, cfg = _cfgs(cache_b0=4)
    c = kv.init_cache(cfg, 2, 9, "static", dtype=torch.bfloat16, device="cpu")
    c["k"].normal_()
    back = convert.cache_from_numpy(convert.cache_to_numpy(c), "cpu")
    assert back["k"].dtype == torch.bfloat16 and torch.equal(back["k"], c["k"])
