"""Port of the serving engines (``repro.serving.steps`` / ``engine``):
``Engine(policy="ggarray")`` and ``BatchEngine`` (``grow_chunk`` 1 and
``"doubling"``; ``paged_attend_impl`` ``"levels"`` and ``"pallas"``) on
``reduced("qwen2.5-3b", cache_b0=8)`` with the reference's own parameters
(``convert.params_from_numpy``).  Held to the reference:

* teacher-forced logits within 5e-4 at every step (f32; the two packages
  differ only in the order of summation);
* greedy output token for token;
* grow events, copied and allocated bytes, host syncs, pool counters and
  the pool bound equal;
* page tables, the free bitmap, lengths and the allocator bitwise equal
  after every BatchEngine step, the K/V pools within 5e-4.

The reference's serving runs compile for a while, so they are shared
through module-scoped fixtures."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import transformer as rtf
from repro.serving import steps as rsteps
from repro.serving.engine import BatchEngine as RBatchEngine
from repro.serving.engine import Engine as REngine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import common
from repro_torch.serving import steps
from repro_torch.serving.engine import BatchEngine, Engine

TOL = dict(rtol=5e-4, atol=5e-4)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [11], [12, 13], [3, 1, 4, 1, 5, 9], [2, 6],
           [5, 3, 5, 8, 9, 7, 9, 3], [2, 7, 1, 8], [6, 6, 6], list(range(20, 41))]
NEW = 12


@pytest.fixture(scope="module")
def model():
    rcfg = rconfigs.reduced("qwen2.5-3b", cache_b0=8)
    cfg = configs.reduced("qwen2.5-3b", cache_b0=8)
    rparams = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rparams, params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")


@pytest.fixture(scope="module")
def ref_engine(model):
    rcfg, _, rparams, _ = model
    eng = REngine(rparams, rcfg, policy="ggarray", max_len=64)
    return eng.generate(PROMPTS, NEW, temperature=0.0), eng.stats


def test_engine_ggarray_matches_reference(model, ref_engine):
    _, cfg, _, params = model
    want, rstats = ref_engine
    common.reset_launch_counts()
    eng = Engine(params, cfg, policy="ggarray", device="cpu")
    assert eng.generate(PROMPTS, NEW) == want
    st = eng.stats
    assert (st.grow_events, st.copied_bytes, st.allocated_bytes, st.decode_steps) == (
        rstats.grow_events, rstats.copied_bytes, rstats.allocated_bytes, rstats.decode_steps)
    assert st.grow_events >= 1 and st.copied_bytes == 0
    assert st.host_syncs == 1 == eng.obs.registry.counter("serve.host_syncs").value(site="token_drain")
    assert common.launch_counts() == {k: 0 for k in common.KERNELS}  # CPU: plain versions only


@pytest.mark.parametrize("policy,impl", [("ggarray", "levels"), ("paged", "levels"), ("paged", "pallas")])
def test_teacher_forced_logits_match_reference_at_every_step(model, policy, impl):
    rcfg, cfg, rparams, params = model
    rcfg = dataclasses.replace(rcfg, paged_attend_impl=impl)
    cfg = dataclasses.replace(cfg, paged_attend_impl=impl)
    rng = np.random.default_rng(11)
    B, S, n = 3, 6, 14  # decodes across two slab / bucket boundaries
    toks = rng.integers(0, cfg.vocab_size, (B, S + n)).astype(np.int32)
    lens = np.asarray([6, 4, 5], np.int32)
    rl, rc = rsteps.prefill(rparams, jnp.asarray(toks[:, :S]), rcfg, capacity_hint=S + n,
                            policy=policy, lengths=jnp.asarray(lens))
    pl, pc = steps.prefill(params, torch.from_numpy(toks[:, :S]), cfg, capacity_hint=S + n,
                           policy=policy, lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
    length = lens.copy()
    for t in range(n):
        tok = toks[np.arange(B), length]  # teacher forcing: the true next token
        rl, rc = rsteps.decode_step(rparams, jnp.asarray(tok), rc, jnp.asarray(length), rcfg)
        pl, pc = steps.decode_step(params, torch.from_numpy(tok), pc, torch.from_numpy(length), cfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL, err_msg=f"step {t}")
        length = length + 1


def test_prefill_chunk_matches_reference(model):
    """One slot's prompt through three chunks into claimed slabs (the
    BatchEngine's admission), logits and pools against the reference."""
    rcfg, cfg, rparams, params = model
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, cfg.vocab_size, 70).astype(np.int32)
    maxp = 12
    rc = rsteps.init_decode_caches(rcfg, 2, maxp * 8, policy="paged")
    pc = steps.init_decode_caches(cfg, 2, maxp * 8, policy="paged", device="cpu")
    row = np.full((maxp,), -1, np.int32)
    row[:9] = rng.permutation(2 * maxp)[:9]
    t0 = 0
    for width in (32, 32, 8):
        live = min(width, len(prompt) - t0)
        chunk = np.zeros((1, width), np.int32)
        chunk[0, :live] = prompt[t0:t0 + live]
        rl, rc = rsteps.prefill_chunk(rparams, jnp.asarray(chunk), rc, jnp.int32(1), jnp.int32(t0),
                                      jnp.int32(live), jnp.asarray(row), rcfg, first=t0 == 0)
        pl, pc = steps.prefill_chunk(params, torch.from_numpy(chunk), pc, 1, t0, live,
                                     torch.from_numpy(row), cfg, first=t0 == 0)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
        for key in ("k_pool", "v_pool"):
            np.testing.assert_allclose(pc[0][key].numpy(), np.asarray(rc[0][key]), **TOL)
        t0 += live


def _pools(c, key):
    p = c[key]
    return np.concatenate([np.asarray(e) for e in p], axis=1) if isinstance(p, tuple) else np.asarray(p)


def _check_same_state(rbe, pbe):
    for rc, pc in zip(rbe.caches, pbe.caches):
        np.testing.assert_array_equal(pc["pages"].numpy(), np.asarray(rc["pages"]))
        for key in ("k_pool", "v_pool"):
            ours = np.concatenate([e.numpy() for e in pc[key]], axis=1) if isinstance(pc[key], tuple) \
                else pc[key].numpy()
            np.testing.assert_allclose(ours, _pools(rc, key), **TOL)
    np.testing.assert_array_equal(pbe.free_dev.numpy(), np.asarray(rbe.free_dev))
    np.testing.assert_array_equal(pbe.lengths.numpy(), np.asarray(rbe.lengths))
    np.testing.assert_array_equal(pbe._len_host, rbe._len_host)
    np.testing.assert_array_equal(pbe.alloc.free, rbe.alloc.free)
    np.testing.assert_array_equal(pbe.alloc.refcount, rbe.alloc.refcount)
    assert pbe.book.pages_of == rbe.book.pages_of
    assert pbe._extent_sizes == rbe._extent_sizes


STATS = ("admitted", "completed", "prefills", "prefill_chunks", "decode_steps", "pool_grow_events",
         "pool_copied_bytes", "grown_slabs", "reused_slabs", "released_slabs", "peak_live_tokens",
         "peak_pool_tokens", "host_syncs")


@pytest.mark.parametrize("grow_chunk,impl", [(1, "levels"), (1, "pallas"), ("doubling", "levels"),
                                             ("doubling", "pallas"), ("tz", "levels"),
                                             ("geometric", "levels")])
def test_batch_engine_matches_reference_step_for_step(model, ref_engine, grow_chunk, impl):
    rcfg, cfg, rparams, params = model
    rcfg = dataclasses.replace(rcfg, paged_attend_impl=impl)
    cfg = dataclasses.replace(cfg, paged_attend_impl=impl)
    rbe = RBatchEngine(rparams, rcfg, max_batch=8, grow_chunk=grow_chunk)
    pbe = BatchEngine(params, cfg, max_batch=8, grow_chunk=grow_chunk, device="cpu")
    rids = [(rbe.submit(p, NEW), pbe.submit(p, NEW)) for p in PROMPTS]
    while True:
        more = rbe.step()
        assert pbe.step() == more
        _check_same_state(rbe, pbe)
        if not more:
            break
    rout, pout = rbe.run(), pbe.run()
    for (rr, pr), want in zip(rids, ref_engine[0]):
        assert pout[pr] == rout[rr] == want  # and the ggarray Engine's tokens
    for name in STATS:
        assert getattr(pbe.stats, name) == getattr(rbe.stats, name), name
    st = pbe.stats
    assert st.host_syncs == 2 and st.reused_slabs > 0
    assert 1 <= st.prefill_widths <= 2 * len(pbe.sched.buckets)  # O(log chunk) widths
    if grow_chunk == 1:
        assert st.peak_pool_tokens < 2 * st.peak_live_tokens + pbe.T * pbe.B
    if grow_chunk in ("doubling", "tz"):
        assert st.pool_copied_bytes == 0 and sum(n > 0 for n in pbe._extent_sizes) > 1
    else:
        assert st.pool_copied_bytes > 0  # flat pools grow by realloc
    pbe.check_free_list()
    assert pbe.alloc.live_count == 0


def test_batch_engine_stop_token_reads_every_step(model):
    _, cfg, _, params = model
    be = BatchEngine(params, cfg, max_batch=2, device="cpu")
    out = be.run_all([[1, 2, 3]], 6)
    be2 = BatchEngine(params, cfg, max_batch=2, stop_token=int(out[0][4]), device="cpu")
    out2 = be2.run_all([[1, 2, 3]], 6)
    assert len(out2[0]) <= len(out[0])
    assert be2.obs.registry.counter("serve.host_syncs").value(site="stop_drain") > 0
    be2.check_free_list()


def test_batch_engine_quota_is_enforced(model):
    from repro_torch.pool import QuotaExceeded

    _, cfg, _, params = model
    be = BatchEngine(params, cfg, max_batch=2, quota_slabs=1, device="cpu")
    be.submit(list(range(1, 12)), 4)  # 11 tokens: needs 2 slabs of 8
    with pytest.raises(QuotaExceeded):
        be.run()


def test_free_list_check_catches_drift(model):
    _, cfg, _, params = model
    be = BatchEngine(params, cfg, max_batch=2, device="cpu")
    be.run_all([[1, 2, 3]], 2)
    be.free_dev[0] = not bool(be.free_dev[0])
    with pytest.raises(AssertionError, match="drifted"):
        be.check_free_list()


def test_unported_options_raise_naming_the_roadmap(model):
    _, cfg, _, params = model
    for kwargs in (dict(admission="monolithic"), dict(prefix_cache=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            BatchEngine(params, cfg, device="cpu", **kwargs)
    # instrument=True (the device counter plane, K15) is ported: accepted
    for make in (Engine, BatchEngine):
        eng = make(params, cfg, device="cpu", instrument=True)
        assert eng.cfg.instrument and eng.drain_device_counters()["paged_attend.lanes"] == 0.0
    for policy in ("static", "semistatic", "two_phase"):  # ported: accepted
        assert Engine(params, cfg, policy=policy, device="cpu").policy == policy
    with pytest.raises(ValueError, match="BatchEngine"):
        Engine(params, cfg, policy="paged", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatchEngine(params, dataclasses.replace(cfg, cache_quant=True), device="cpu")


def test_engines_need_a_card_unless_asked_for_cpu(model):
    _, cfg, _, params = model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for make in (lambda: Engine(params, cfg), lambda: BatchEngine(params, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_temperature_sampling_draws_from_the_generator(model):
    _, cfg, _, params = model
    outs = [Engine(params, cfg, device="cpu", seed=s).generate([[1, 2, 3]], 8, temperature=1.0)
            for s in (0, 0, 1)]
    assert outs[0] == outs[1] and len(outs[2][0]) == 11


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--batch", "2", "--new-tokens", "5"])
    out = capsys.readouterr().out
    assert "policy=ggarray" in out and "grow_events=" in out and "seq0:" in out
    serve.main(["--device", "cpu", "--batch", "2", "--new-tokens", "20", "--policy", "two_phase"])
    out = capsys.readouterr().out
    assert "policy=two_phase" in out and "grow_events=1" in out and "host_syncs=1" in out
