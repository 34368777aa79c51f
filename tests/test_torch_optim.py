"""Port of the optimisers (``repro.optim``): AdamW, its global norm, the
warmup-cosine schedule and int8 gradient compression with error feedback,
each fed the same seeded numpy trees on both sides.

Tolerances: AdamW's parameters and moments within ``ADAMW_ULPS`` = 2 ulp
of the reference's, element by element, given the reference's global norm
(the update's arithmetic is op for op the same; the norm's sum of squares
runs in another order, and one ulp of the clip scale, carried through a
moment that nearly cancels, moves it by many of its own ulps); the global
norm itself and the schedule
within ``NORM_RTOL`` = 1e-6 (the sums run in another order); quantisation
and compression bitwise (IEEE division, round half to even)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as radamw
from repro.optim import compression as rcomp
from repro.optim import schedule as rsched
from repro_torch.convert import tensor_to_numpy
from repro_torch.optim import adamw, compression, schedule
from repro_torch.tree import leaves, paths, tree_map

ADAMW_ULPS = 2
NORM_RTOL = 1e-6
SHAPES = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5, 2)}, "e": (2, 40)}


def _build(shapes, make):
    if isinstance(shapes, dict):
        return {k: _build(v, make) for k, v in sorted(shapes.items())}
    return make(shapes)


def _to_jax(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_torch(tree, dtype=None):
    def one(a):
        t = torch.from_numpy(np.array(a, np.float32))
        return t if dtype is None else t.to(dtype)

    return tree_map(one, tree)


def _ordered(bits: np.ndarray) -> np.ndarray:
    """IEEE bit patterns (uint16 or uint32) → integers ordered like the floats."""
    width = bits.dtype.itemsize * 8
    b = bits.astype(np.int64)
    sign = 1 << (width - 1)
    return np.where(b & sign, -(b & (sign - 1)), b)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        a = tensor_to_numpy(x)
    else:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _max_ulps(ours, theirs) -> int:
    return int(np.max(np.abs(_ordered(_bits(ours)) - _ordered(_bits(theirs))), initial=0))


@pytest.mark.parametrize("chunk", [adamw.CHUNK, 7])
@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_steps(dtype, clip, chunk, monkeypatch):
    """Three steps on identical params, grads and moments, lr scaled by the
    schedule: params, moments, step and grad norm.  ``chunk`` = 7 slices
    every leaf into 7-element pieces, which must not change a bit."""
    monkeypatch.setattr(adamw, "CHUNK", chunk)
    rng = np.random.default_rng(3)
    grad_scale = 1.0 if clip == "active" else 1e-3
    p_np = _build(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rparams = _to_jax(p_np, jdt)
    params = _to_torch(p_np, tdt)
    rstate, state = radamw.init(rparams), adamw.init(params)
    rcfg, cfg = radamw.AdamWConfig(lr=1e-2), adamw.AdamWConfig(lr=1e-2)
    for it in range(3):
        g_np = _build(SHAPES, lambda s: (rng.standard_normal(s) * grad_scale).astype(np.float32))
        rgrads, grads = _to_jax(g_np, jdt), _to_torch(g_np, tdt)
        rparams, rstate, rnorm = radamw.update(
            rgrads, rstate, rparams, rcfg, rsched.warmup_cosine(it, warmup=2, total=5))
        np.testing.assert_allclose(float(adamw.global_norm(grads)), float(rnorm), rtol=NORM_RTOL)
        with monkeypatch.context() as mp:  # the update's arithmetic, given the same norm
            mp.setattr(adamw, "global_norm", lambda _: torch.tensor(np.asarray(rnorm)))
            out, state, norm = adamw.update(
                grads, state, params, cfg, schedule.warmup_cosine(it, warmup=2, total=5))
        assert out is params  # updated in place
        clipped = float(rnorm) > rcfg.grad_clip
        assert clipped == (clip == "active")
        assert int(state.step) == int(rstate.step) == it + 1
        for tree, rtree in ((params, rparams), (state.m, rstate.m), (state.v, rstate.v)):
            for (key, ours), theirs in zip(paths(tree), jax.tree.leaves(rtree)):
                assert ours.dtype == (tdt if tree is params else torch.float32), key
                assert _max_ulps(ours, theirs) <= ADAMW_ULPS, (key, it)


def test_adamw_init_and_global_norm_match_reference():
    rng = np.random.default_rng(4)
    t_np = _build(SHAPES, lambda s: (rng.standard_normal(s) * 3).astype(np.float32))
    st = adamw.init(_to_torch(t_np))
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert all(torch.count_nonzero(x) == 0 and x.dtype == torch.float32
               for x in leaves(st.m) + leaves(st.v))
    np.testing.assert_allclose(float(adamw.global_norm(_to_torch(t_np))),
                               float(radamw.global_norm(_to_jax(t_np))), rtol=NORM_RTOL)
    # bf16 leaves are squared in f32
    np.testing.assert_allclose(
        float(adamw.global_norm(_to_torch(t_np, torch.bfloat16))),
        float(radamw.global_norm(_to_jax(t_np, jnp.bfloat16))), rtol=NORM_RTOL)


@pytest.mark.parametrize("warmup,total,floor", [(5, 20, 0.1), (0, 10, 0.0), (100, 10_000, 0.1)])
def test_warmup_cosine_matches_reference(warmup, total, floor):
    """Across warmup, the cosine decay and the floor past ``total``."""
    for step in list(range(0, total + 6)) + [total * 3]:
        if total > 100 and step % 97 and step not in (warmup - 1, warmup, total):
            continue
        ours = schedule.warmup_cosine(step, warmup=warmup, total=total, floor=floor)
        theirs = rsched.warmup_cosine(step, warmup=warmup, total=total, floor=floor)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(float(ours), float(theirs), rtol=NORM_RTOL, atol=1e-7)
    assert float(schedule.warmup_cosine(total + 5, warmup=warmup, total=total, floor=floor)) == \
        pytest.approx(floor, abs=1e-7)


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "tiny", "bf16"])
def test_quantize_is_bitwise_the_reference(case):
    rng = np.random.default_rng(5)
    x = {"normal": (rng.standard_normal((7, 33)) * 3).astype(np.float32),
         # x / scale lands exactly on .5: round half to even, both signs, and the clip edge
         "ties": np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0, 127.0], np.float32),
         "zeros": np.zeros((5,), np.float32),
         "tiny": (rng.standard_normal((64,)) * 1e-30).astype(np.float32),
         "bf16": (rng.standard_normal((9, 9)) * 0.01).astype(np.float32)}[case]
    jx = jnp.asarray(x, jnp.bfloat16 if case == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if case == "bf16" else torch.float32)
    q, s = compression.quantize(tx)
    rq, rs = rcomp.quantize(jx)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert _bits(s).tobytes() == _bits(rs).tobytes()
    np.testing.assert_array_equal(_bits(compression.dequantize(q, s)),
                                  _bits(rcomp.dequantize(rq, rs)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_grads_with_error_feedback_over_steps(dtype):
    """Four steps of fresh grads: the compressed grads and the residual
    bitwise the reference's, the residual updated in place."""
    rng = np.random.default_rng(6)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    g0 = _build(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32))
    ref_ef, ef = rcomp.ef_init(_to_jax(g0, jdt)), compression.ef_init(_to_torch(g0, tdt))
    residual = ef.residual
    for _ in range(4):
        g_np = _build(SHAPES, lambda s: (rng.standard_normal(s) * rng.uniform(0.1, 10)).astype(np.float32))
        rg, ref_ef = rcomp.compress_grads(_to_jax(g_np, jdt), ref_ef)
        tg, ef = compression.compress_grads(_to_torch(g_np, tdt), ef)
        assert ef.residual is residual
        for ours, theirs in zip(leaves(tg), jax.tree.leaves(rg)):
            assert ours.dtype == tdt
            np.testing.assert_array_equal(_bits(ours), _bits(theirs))
        for ours, theirs in zip(leaves(ef.residual), jax.tree.leaves(ref_ef.residual)):
            np.testing.assert_array_equal(_bits(ours), _bits(theirs))


def test_tree_order_and_keys_are_jax_s():
    from repro_torch.tree import unflatten

    tree = {"b": [np.zeros(1), {"z": np.ones(2), "a": np.ones(3)}], "a": None, "c": np.zeros(4)}
    ours = [(k, v.shape) for k, v in paths(tree)]
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    theirs = ["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path) for path, _ in flat]
    assert [k for k, _ in ours] == theirs == ["b/0", "b/1/a", "b/1/z", "c"]
    assert [s for _, s in ours] == [v.shape for _, v in flat]
    back = unflatten(tree, [1, 2, 3, 4])
    assert back == {"a": None, "b": [1, {"a": 2, "z": 3}], "c": 4}
    with pytest.raises(ValueError):
        unflatten(tree, [1, 2, 3, 4, 5])
    st = adamw.AdamWState(step=torch.zeros(()), m={"w": torch.zeros(1)}, v={"w": torch.ones(1)})
    assert [k for k, _ in paths(st)] == [".step", ".m/w", ".v/w"]
