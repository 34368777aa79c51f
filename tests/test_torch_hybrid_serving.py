"""Port of serving for the remaining model families (``repro.serving``
on MoE, Mamba, the Jamba hybrid, encoder–decoder and prefix-embedding
stacks), on the reduced configs with the reference's own parameters
(``convert.params_from_numpy``):

* ``steps.prefill`` then ``decode_step`` against the reference's
  ``forward`` over the longer sequence, within 5e-4 (the tolerance of
  ``tests/serving/test_steps_engine.py::test_decode_matches_forward``);
  MoE stacks against the reference's own prefill and decode, since an
  expert's capacity depends on how many tokens are routed together;
* ``Engine(policy="ggarray")`` token for token with the reference's
  ``Engine`` (the cache grows, ``cache_b0=4``);
* chunked ``BatchEngine`` on Jamba token for token with the reference's
  ``Engine`` at equal lengths and with its monolithic ``BatchEngine`` on
  ragged prompts with slot reuse (``tests/serving/
  test_chunked_exactness.py``), and the hybrid cases of
  ``tests/serving/test_batch_engine.py``.

The reference's ``Engine`` right-pads a ragged batch through the Mamba
recurrence; the port keeps that, so engine against engine agrees on any
prompts, and the hybrid cases against the monolithic oracle use equal
lengths, as the reference's tests do."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import encdec as rencdec
from repro.models import transformer as rtf
from repro.serving import steps as rsteps
from repro.serving.engine import BatchEngine as RBatchEngine
from repro.serving.engine import Engine as REngine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import encdec
from repro_torch.serving import steps
from repro_torch.serving.engine import BatchEngine, Engine

TOL = dict(rtol=5e-4, atol=5e-4)


@functools.lru_cache(maxsize=None)
def _model(arch: str, cache_b0: int = 8):
    rcfg = rconfigs.reduced(arch, cache_b0=cache_b0)
    cfg = configs.reduced(arch, cache_b0=cache_b0)
    rparams = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rparams, params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")


def _prompts(lengths, seed=11):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 50, L)] for L in lengths]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mamba2-2.7b", "seamless-m4t-large-v2",
                                  "internvl2-26b"])
def test_decode_matches_forward(arch):
    """Prefill(S) + decode(1) logits == the reference's forward(S + 1) at
    the last position; the encoder–decoder with memory (cross K/V in the
    caches), the VLM with prefix embeddings (the decode position counts
    them)."""
    rcfg, cfg, rparams, params = _model(arch)
    B, S = 2, 16
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    kw, rkw = {}, {}
    if cfg.n_enc_layers:
        frames = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(np.float32)
        kw["memory"] = encdec.encode(params["encoder"], torch.from_numpy(frames), cfg)
        rkw["memory"] = rencdec.encode(rparams["encoder"], jnp.asarray(frames), rcfg)
    if cfg.n_prefix_embeds:
        pe = (rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model)) * 0.02).astype(np.float32)
        kw["prefix_embeds"], rkw["prefix_embeds"] = torch.from_numpy(pe), jnp.asarray(pe)
    want = np.asarray(rtf.forward(rparams, jnp.asarray(toks), rcfg, **rkw)[0][:, -1])
    P = cfg.n_prefix_embeds if "prefix_embeds" in kw else 0
    _, caches = steps.prefill(params, torch.from_numpy(toks[:, :S]), cfg, capacity_hint=P + S + 4, **kw)
    if cfg.n_enc_layers:
        attn = [c for c, k in zip(caches, cfg.layout) if k == "attn"][0]
        assert attn["cross_k"].shape == (cfg.n_periods, B, S, cfg.n_kv_heads, cfg.head_dim)
    got, _ = steps.decode_step(params, torch.from_numpy(toks[:, S]), caches, P + S, cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
def test_moe_decode_matches_reference_decode(arch):
    """An MoE layer's capacity depends on the tokens routed together
    (C = 1 at a decode step of two rows), so decode is held to the
    reference's own prefill + decode, not to a forward pass."""
    rcfg, cfg, rparams, params = _model(arch)
    B, S = 2, 16
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    rl, rc = rsteps.prefill(rparams, jnp.asarray(toks[:, :S]), rcfg, capacity_hint=S + 4)
    want, _ = rsteps.decode_step(rparams, jnp.asarray(toks[:, S]), rc, jnp.int32(S), rcfg)
    logits, caches = steps.prefill(params, torch.from_numpy(toks[:, :S]), cfg, capacity_hint=S + 4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl), **TOL)
    got, _ = steps.decode_step(params, torch.from_numpy(toks[:, S]), caches, S, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-v0.1-52b", "mamba2-2.7b",
                                  "llama4-scout-17b-a16e", "seamless-m4t-large-v2", "internvl2-26b"])
def test_engine_ggarray_matches_reference(arch):
    """Greedy output token for token, the cache growing past cache_b0 = 4
    in the attention slots (none in mamba2); grow events and bytes equal.
    Encoder–decoder and VLM configs serve as decoder-only stacks in both."""
    rcfg, cfg, rparams, params = _model(arch, cache_b0=4)
    prompts = _prompts([5, 3, 7])
    reng = REngine(rparams, rcfg, policy="ggarray", max_len=64)
    want = reng.generate(prompts, max_new_tokens=6, temperature=0.0)
    eng = Engine(params, cfg, policy="ggarray", device="cpu")
    assert eng.generate(prompts, 6) == want
    st, rst = eng.stats, reng.stats
    assert (st.grow_events, st.copied_bytes, st.allocated_bytes) == (
        rst.grow_events, rst.copied_bytes, rst.allocated_bytes)
    assert (st.grow_events > 0) == ("attn" in cfg.layout)
    assert st.host_syncs == 1


@pytest.mark.parametrize("policy", ["semistatic", "two_phase"])
def test_engine_growing_policies_on_the_hybrid(policy):
    """Growth and the two-phase freeze touch the attention slot only."""
    rcfg, cfg, rparams, params = _model("jamba-v0.1-52b", cache_b0=4)
    prompts = _prompts([6, 6])
    reng = REngine(rparams, rcfg, policy=policy, max_len=64)
    want = reng.generate(prompts, 10, temperature=0.0)
    eng = Engine(params, cfg, policy=policy, device="cpu")
    assert eng.generate(prompts, 10) == want
    st, rst = eng.stats, reng.stats
    assert st.grow_events >= 1
    assert (st.grow_events, st.freeze_events, st.copied_bytes, st.allocated_bytes) == (
        rst.grow_events, rst.freeze_events, rst.copied_bytes, rst.allocated_bytes)
    mamba = [c for c, k in zip(eng.caches, cfg.layout) if k == "mamba"]
    assert all(set(c) == {"conv", "ssd"} for c in mamba)


def test_chunked_matches_engine_hybrid_equal_length():
    """Jamba, equal-length prompts of 40 = 32 + an 8-token exact tail."""
    rcfg, cfg, rparams, params = _model("jamba-v0.1-52b", cache_b0=4)
    prompts = _prompts([40, 40, 40], seed=3)
    want = REngine(rparams, rcfg, policy="ggarray", max_len=64).generate(prompts, 4, temperature=0.0)
    be = BatchEngine(params, cfg, max_batch=3, device="cpu")
    assert be.run_all(prompts, 4) == want
    assert be.stats.prefill_chunks == 6
    be.check_free_list()


def test_chunked_matches_monolithic_hybrid_ragged_with_reuse():
    """Ragged Jamba prompts through two slots: a reused slot's first chunk
    must not start from the previous tenant's Mamba state, and decode
    steps interleaved with prefill chunks must not move a prefilling
    slot's state."""
    rcfg, cfg, rparams, params = _model("jamba-v0.1-52b", cache_b0=4)
    prompts = _prompts([33, 40, 37], seed=7)
    want = RBatchEngine(rparams, rcfg, max_batch=2, admission="monolithic").run_all(prompts, 4)
    be = BatchEngine(params, cfg, max_batch=2, device="cpu")
    assert be.run_all(prompts, 4) == want
    be.check_free_list()


def test_batch_engine_mamba_hybrid_arch():
    rcfg, cfg, rparams, params = _model("jamba-v0.1-52b")
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [2, 7, 1, 8], [9, 9, 9, 9]]
    want = REngine(rparams, rcfg, policy="ggarray", max_len=64).generate(prompts, 5, temperature=0.0)
    be = BatchEngine(params, cfg, max_batch=4, device="cpu")
    rids = [be.submit(p, 5) for p in prompts]
    out = be.run()
    for i, rid in enumerate(rids):
        assert out[rid] == want[i]
    # ragged prompts (one shorter than the conv window) still serve
    be2 = BatchEngine(params, cfg, max_batch=2, device="cpu")
    outs = be2.run_all([[1], [2, 3], [4, 5, 6, 7, 8]], 4)
    assert [len(o) for o in outs] == [5, 6, 9]
    be2.check_free_list()


@pytest.mark.parametrize("arch,grow_chunk", [("dbrx-132b", 1), ("dbrx-132b", "doubling"),
                                             ("mamba2-2.7b", 1)])
def test_batch_engine_matches_reference(arch, grow_chunk):
    """MoE stacks through the paged pool (routing at decode batch size),
    and a pure SSM stack with no attention slot: token for token with the
    reference's chunked BatchEngine on ragged prompts, pool counters equal."""
    rcfg, cfg, rparams, params = _model(arch, cache_b0=4)
    prompts = _prompts([9, 3, 12, 5, 7], seed=5)
    rbe = RBatchEngine(rparams, rcfg, max_batch=3, grow_chunk=grow_chunk)
    want = rbe.run_all(prompts, 5)
    be = BatchEngine(params, cfg, max_batch=3, grow_chunk=grow_chunk, device="cpu")
    assert be.run_all(prompts, 5) == want
    assert (be.stats.pool_grow_events, be.stats.prefill_chunks, be.stats.decode_steps) == (
        rbe.stats.pool_grow_events, rbe.stats.prefill_chunks, rbe.stats.decode_steps)
    be.check_free_list()


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-26b"])
def test_batch_engine_refuses_encoder_decoder_and_prefix_stacks(arch):
    _, cfg, _, params = _model(arch)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        BatchEngine(params, cfg, device="cpu")


def test_batch_engine_checks_the_ssm_chunk_grid():
    _, cfg, _, params = _model("jamba-v0.1-52b")
    with pytest.raises(ValueError, match="ssm.chunk_size"):
        BatchEngine(params, configs.reduced("jamba-v0.1-52b", attention_chunk=4), prefill_chunk=4,
                    device="cpu")
    with pytest.raises(ValueError, match="attention_chunk"):
        BatchEngine(params, cfg, prefill_chunk=40, device="cpu")
