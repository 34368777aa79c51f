"""End-to-end system test of the port: train → checkpoint → restore →
serve, on the CPU — the mirror of ``tests/test_system.py`` — and serving
from parameters that require grad, which must build no graph."""
import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.serving.engine import BatchEngine, Engine
from repro_torch.train import loop as loop_mod
from repro_torch.train import step as step_mod
from repro_torch.tree import leaves, tree_map


def test_train_checkpoint_serve_roundtrip(tmp_path):
    cfg = configs.reduced("qwen2.5-3b", cache_b0=8)
    d = str(tmp_path / "ckpt")
    out = loop_mod.run(
        cfg,
        loop_mod.LoopConfig(steps=6, batch=2, seq=16, ckpt_dir=d, ckpt_every=3, log_every=100),
        device="cpu",
    )
    assert all(np.isfinite(out["losses"]))
    step = ckpt.latest_step(d)
    assert step == 6

    fresh = step_mod.init_train_state(0, cfg, device="cpu")
    restored, meta = ckpt.restore(d, step, fresh)
    assert meta["next_step"] == 6
    assert not all(torch.equal(a, b) for a, b in zip(leaves(fresh.params), leaves(restored.params)))

    prompts = [[1, 2, 3], [7, 8]]
    outs = {}
    for policy in ("ggarray", "static"):
        eng = Engine(restored.params, cfg, policy=policy, max_len=64, device="cpu")
        outs[policy] = eng.generate(prompts, max_new_tokens=10)
    assert outs["ggarray"] == outs["static"]
    assert all(len(o) == len(p) + 10 for o, p in zip(outs["ggarray"], prompts))


def _no_graph(tensors) -> bool:
    return all(not t.requires_grad and t.grad_fn is None for t in tensors)


def test_serving_trained_params_builds_no_graph():
    """Parameters that require grad serve exactly as detached copies do:
    the same tokens, and no cache tensor carries a graph."""
    cfg = configs.reduced("qwen2.5-3b", cache_b0=8)
    state = step_mod.init_train_state(0, cfg, device="cpu")
    assert all(p.requires_grad for p in leaves(state.params))
    detached = tree_map(lambda p: p.detach(), state.params)
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11]]
    eng = Engine(state.params, cfg, policy="ggarray", max_len=64, device="cpu")
    got = eng.generate(prompts, max_new_tokens=12)
    want = Engine(detached, cfg, policy="ggarray", max_len=64, device="cpu").generate(
        prompts, max_new_tokens=12)
    assert got == want
    assert _no_graph(t for c in eng.caches for v in c.values()
                     for t in (v if isinstance(v, tuple) else (v,)))

    be = BatchEngine(state.params, cfg, max_batch=2, device="cpu")
    bout = be.run_all(prompts, max_new_tokens=12)
    assert bout == want
    assert _no_graph(t for c in be.caches for v in c.values() if isinstance(v, torch.Tensor)
                     for t in (v,))
