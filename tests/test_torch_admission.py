"""Port of monolithic admission (``BatchEngine(admission="monolithic")``:
one whole-prompt prefill per request, ``policy="static"``, scattered into
the claimed slabs), as in the monolithic cases of ``tests/serving/
test_chunked_exactness.py``, on reduced configs (``cache_b0=4``) with the
reference's own parameters:

* monolithic admission token for token with the reference's monolithic
  ``BatchEngine`` (int8 cache too), with its page tables and allocator
  bitwise, and with the port's chunked ``BatchEngine`` and ``Engine``
  (prompts of 1–3 chunks of 32);
* the Jamba hybrid on ragged prompts through two slots (slot reuse, a
  short prompt's conv window left-padded): monolithic equal to the
  reference's monolithic and to the port's chunked admission."""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as rconfigs
from repro.models import transformer as rtf
from repro.serving.engine import BatchEngine as RBatchEngine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.serving.engine import BatchEngine, Engine


def _model(arch, **over):
    rcfg = rconfigs.reduced(arch, cache_b0=4, **over)
    cfg = configs.reduced(arch, cache_b0=4, **over)
    rparams = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rparams, params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")


def _prompts(lengths, seed=11):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 50, L)] for L in lengths]


@pytest.mark.parametrize("grow_chunk", [1, "doubling"])
def test_monolithic_matches_reference_chunked_and_engine(grow_chunk):
    """Lengths spanning 1–3 chunks; three slots, so slots are reused."""
    rcfg, cfg, rparams, params = _model("qwen2.5-3b")
    prompts = _prompts([33, 40, 64, 70, 5])
    t_new = 4
    ref = RBatchEngine(rparams, rcfg, max_batch=3, admission="monolithic", grow_chunk=grow_chunk)
    want = ref.run_all(prompts, t_new)
    mono = BatchEngine(params, cfg, max_batch=3, admission="monolithic", grow_chunk=grow_chunk,
                       device="cpu")
    assert mono.run_all(prompts, t_new) == want
    mono.check_free_list()
    np.testing.assert_array_equal(mono.alloc.refcount, ref.alloc.refcount)
    np.testing.assert_array_equal(mono.caches[0]["pages"].numpy(), np.asarray(ref.caches[0]["pages"]))
    st, rs = mono.stats, ref.stats
    assert (st.prefills, st.prefill_chunks, st.decode_steps, st.pool_copied_bytes) == (
        rs.prefills, rs.prefill_chunks, rs.decode_steps, rs.pool_copied_bytes)
    assert st.prefill_chunks == 0 and st.prefills == len(prompts)
    # the pool bound the reference asserts for its flat pool
    if grow_chunk == 1:
        assert st.peak_pool_tokens < 2 * st.peak_live_tokens + mono.T * mono.B
    assert BatchEngine(params, cfg, max_batch=3, device="cpu").run_all(prompts, t_new) == want
    assert Engine(params, cfg, policy="ggarray", max_len=80, device="cpu").generate(prompts, t_new) == want
    state = mono._flightrec_state()
    assert state["admission"] == "monolithic" and state["scheduler"] is None


def test_monolithic_int8_matches_reference():
    """An int8 cache through monolithic admission: the static prefill's
    codes and scales scattered into the four pools."""
    rcfg, cfg, rparams, params = _model("qwen2.5-3b")
    rcfg, cfg = (dataclasses.replace(c, cache_quant=True) for c in (rcfg, cfg))
    prompts = _prompts([33, 6, 9], seed=4)
    want = RBatchEngine(rparams, rcfg, max_batch=2, admission="monolithic").run_all(prompts, 4)
    be = BatchEngine(params, cfg, max_batch=2, admission="monolithic", device="cpu")
    assert be.run_all(prompts, 4) == want
    be.check_free_list()


def test_monolithic_hybrid_ragged_with_reuse():
    """Jamba on ragged prompts through two slots: a resumed slot must not
    carry the previous tenant's Mamba state, and a prompt shorter than the
    conv window left-pads it, as the reference's ``_admit`` does."""
    rcfg, cfg, rparams, params = _model("jamba-v0.1-52b")
    prompts = _prompts([33, 40, 2, 37], seed=7)
    t_new = 4
    want = RBatchEngine(rparams, rcfg, max_batch=2, admission="monolithic").run_all(prompts, t_new)
    mono = BatchEngine(params, cfg, max_batch=2, admission="monolithic", device="cpu")
    got = mono.run_all(prompts, t_new)
    assert got == want
    mono.check_free_list()
    assert BatchEngine(params, cfg, max_batch=2, device="cpu").run_all(prompts, t_new) == got


def test_monolithic_admission_counts_and_drains_like_chunked():
    """Host syncs: the two drains of ``run()``; a request of one token
    completes at admission; an empty queue does no work."""
    _, cfg, _, params = _model("qwen2.5-3b")
    be = BatchEngine(params, cfg, max_batch=2, admission="monolithic", device="cpu")
    assert not be.step()
    out = be.run_all([[1, 2, 3], [4, 5, 6, 7, 8]], 1)
    assert [len(o) for o in out] == [4, 6] and be.stats.decode_steps == 0
    assert be.stats.host_syncs == 1  # the first tokens only: no decode stream
    be.check_free_list()
    assert be.alloc.free.all()
