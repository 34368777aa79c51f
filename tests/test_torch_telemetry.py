"""Port of the instrumented serving paths (``repro.serving.engine`` with
``instrument=True``, the instrumented tests of
``tests/serving/test_telemetry.py``): ``Engine`` (ggarray) and
``BatchEngine`` (paged, the group walk and K10/K11) run step for step
against the reference's instrumented engines on ``reduced("qwen2.5-3b",
cache_b0=8)`` with the reference's parameters.  Held to the reference:

* greedy tokens, token for token, equal to the reference's and to the
  uninstrumented port's;
* the drained device counters (``drain_device_counters()``) after every
  step, slot for slot, under the port's parity rule: ``push_back.lanes``
  equals the reference's minus its padded lanes, and
  ``push_back.padded_lanes`` is 0 (``repro_torch/obs/device.py``); every
  other slot is equal;
* the instrumented decode hot path reads nothing from the device.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import transformer as rtf
from repro.serving.engine import BatchEngine as RBatchEngine
from repro.serving.engine import Engine as REngine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.serving.engine import BatchEngine, Engine

PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [11], [3, 1, 4, 1, 5, 9], list(range(20, 70))]
NEW = 10


@pytest.fixture(scope="module")
def model():
    rcfg = rconfigs.reduced("qwen2.5-3b", cache_b0=8)
    cfg = configs.reduced("qwen2.5-3b", cache_b0=8)
    rparams = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rparams, params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")


def _parity(port: dict, ref: dict) -> None:
    """The port's counters == the reference's, with the tiling slots taken
    by the stated rule."""
    want = dict(ref)
    want["push_back.lanes"] = ref["push_back.lanes"] - ref["push_back.padded_lanes"]
    want["push_back.padded_lanes"] = 0.0
    assert port == want


def test_engine_instrumented_matches_reference(model):
    rcfg, cfg, rparams, params = model
    reng = REngine(rparams, rcfg, policy="ggarray", max_len=64, instrument=True)
    peng = Engine(params, cfg, policy="ggarray", instrument=True, device="cpu")
    want = reng.generate(PROMPTS, NEW)
    got = peng.generate(PROMPTS, NEW)
    assert got == want
    assert Engine(params, cfg, policy="ggarray", device="cpu").generate(PROMPTS, NEW) == want
    assert peng.stats.grow_events == reng.stats.grow_events >= 1
    ctr = peng.drain_device_counters()
    _parity(ctr, reng.devctr.counters())
    steps = NEW - 1
    assert ctr["push_back.waves"] == steps * cfg.n_layers
    assert ctr["push_back.lanes"] == ctr["push_back.active_lanes"] == steps * cfg.n_layers * len(PROMPTS)


@pytest.mark.parametrize("impl", ["levels", "pallas"])
def test_batch_engine_instrumented_matches_reference_step_for_step(model, impl):
    rcfg, cfg, rparams, params = model
    rcfg = dataclasses.replace(rcfg, paged_attend_impl=impl)
    cfg = dataclasses.replace(cfg, paged_attend_impl=impl)
    rbe = RBatchEngine(rparams, rcfg, max_batch=4, instrument=True)
    pbe = BatchEngine(params, cfg, max_batch=4, instrument=True, device="cpu")
    rids = [(rbe.submit(p, NEW), pbe.submit(p, NEW)) for p in PROMPTS]
    while True:
        more = rbe.step()
        assert pbe.step() == more
        _parity(pbe.drain_device_counters(), rbe.drain_device_counters())
        if not more:
            break
    rout, pout = rbe.run(), pbe.run()
    plain = BatchEngine(params, cfg, max_batch=4, device="cpu").run_all(PROMPTS, NEW)
    for (rr, pr), want in zip(rids, plain):
        assert pout[pr] == rout[rr] == want
    ctr = pbe.drain_device_counters()
    steps = pbe.stats.decode_steps
    assert ctr["slab_append.waves"] == steps * cfg.n_layers + pbe.stats.prefill_chunks * cfg.n_layers
    assert ctr["paged_attend.launches"] == steps * cfg.n_layers
    assert ctr["paged_attend.lanes"] > 0 and ctr["paged_gather.launches"] > 0
    assert pbe.obs.snapshot()["counters"]["device.paged_attend.lanes"] == ctr["paged_attend.lanes"]
    pbe.check_free_list()


def test_instrumented_decode_hot_path_reads_nothing(model, monkeypatch):
    """With the counter plane on, steady decode steps read nothing: the
    vectors pend in the plane until the explicit drain."""
    _, cfg, _, params = model
    be = BatchEngine(params, cfg, max_batch=4, instrument=True, device="cpu")
    for p in PROMPTS[:4]:
        be.submit(p, 30)
    while be.sched.prefilling or be.sched.pending:
        be.step()
    before = be.drain_device_counters()
    reads = []
    for name in ("item", "cpu", "tolist", "numpy"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _r=real, _n=name, **k: reads.append(_n) or _r(self, *a, **k))
    pend0 = be.devctr.pending
    for _ in range(5):
        be.step()
    assert reads == [], "instrumented decode must not read the device"
    assert be.devctr.pending == pend0 + 5, "each step pends one vector"
    monkeypatch.undo()
    got = be.drain_device_counters()
    assert be.devctr.pending == 0
    assert got["paged_attend.launches"] - before["paged_attend.launches"] == 5 * cfg.n_layers
