"""Port of the loss and the train step (``repro.train.step``): the loss and
every parameter's gradient for each registered architecture, the train
step with microbatches and compression, ``rms_norm``'s hand-written VJP,
the MoE pack's gradient with dropped tokens, remat, the loss mask, and the
per-architecture training smoke test — on the reference's own parameters
(``convert.train_state_from_numpy``) and the same seeded numpy batches.

Tolerances, all f32 (the two packages differ in the order of summation):
the loss, CE and aux within ``LOSS_RTOL`` = 1e-5; each parameter's
gradient within ``GRAD_TOL`` = 1e-4 relative L2; after three AdamW steps
each parameter within ``PARAM_TOL`` = 1e-4 relative L2 — except the
attention's k bias, whose true gradient is 0 (a bias on every key shifts
each query's scores by one constant), so its gradient is rounding noise
that Adam scales to ±lr: it is held to 3·lr per step instead."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data.packing import Packer as RPacker
from repro.models import modules as rmod
from repro.models import transformer as rtf
from repro.optim import adamw as radamw
from repro.train import step as rstep
from repro_torch import configs
from repro_torch.convert import params_from_numpy, train_state_from_numpy, train_state_to_numpy
from repro_torch.data.packing import Packer
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels.common import put_drop_
from repro_torch.models import modules, moe, transformer
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from repro_torch.tree import leaves, paths

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-4


def _rel(ours, theirs) -> float:
    a = np.asarray(theirs, np.float64)
    b = ours.detach().double().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _jax_keys(tree) -> list[str]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path) for path, _ in flat]


def _batch_np(cfg, rng, B=2, S=16) -> dict:
    """A seeded numpy batch with the keys ``make_batch`` gives the family."""
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.n_enc_layers:
        b["frames"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(np.float32)
    elif cfg.n_prefix_embeds:
        b["prefix_embeds"] = (rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model)) * 0.02).astype(np.float32)
    return b


def _pair(arch: str, **over):
    """(reference cfg, port cfg, reference params, port params requiring grad)."""
    rcfg, cfg = rconfigs.reduced(arch, **over), configs.reduced(arch, **over)
    rparams = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    return rcfg, cfg, rparams, params


def _check_loss_and_grads(rcfg, cfg, rparams, params, batch):
    (rloss, rmetrics), rgrads = jax.value_and_grad(rstep.loss_fn, has_aux=True)(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()}, rcfg)
    loss, metrics = tstep.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]), rtol=LOSS_RTOL, atol=1e-7)
    keys = [k for k, _ in paths(params)]
    assert keys == _jax_keys(rgrads)
    for key, g, rg in zip(keys, grads, jax.tree.leaves(rgrads)):
        assert g.shape == rg.shape and g.dtype == torch.float32, key
        assert _rel(g, rg) <= GRAD_TOL, (key, _rel(g, rg))
    return float(loss)


@pytest.mark.parametrize("arch", rconfigs.ARCH_NAMES)
def test_loss_fn_and_grads_match_reference(arch):
    """Every registered architecture, reduced; MoE routes by ``scan`` in the
    reference (ranks are bitwise across methods, ``test_torch_moe.py``)."""
    rcfg, cfg, rparams, params = _pair(arch)
    if rcfg.moe is not None:
        rcfg = dataclasses.replace(rcfg, insertion_method="scan")
    _check_loss_and_grads(rcfg, cfg, rparams, params, _batch_np(cfg, np.random.default_rng(0)))


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
def test_moe_grads_with_dropped_tokens_match_reference(arch):
    """capacity_factor 0.25: E·C slots hold at most a quarter of the T·k
    assignments, so most tokens are dropped in every MoE layer."""
    rcfg0 = rconfigs.reduced(arch)
    moe_cfg = dataclasses.replace(rcfg0.moe, capacity_factor=0.25)
    rcfg, cfg, rparams, params = _pair(arch, moe=moe_cfg)
    rcfg = dataclasses.replace(rcfg, insertion_method="scan")
    B, S = 2, 16
    T, E, k = B * S, moe_cfg.n_experts, moe_cfg.top_k
    C = moe.expert_capacity(cfg.moe, T)
    assert E * C < T * k  # drops are certain
    _check_loss_and_grads(rcfg, cfg, rparams, params, _batch_np(cfg, np.random.default_rng(1), B, S))


@pytest.mark.parametrize("slots", [[0, 1, 2, -1], [2, -1, 0, -1, -1, 1], [-1, -1], [1, 0]])
def test_put_drop_sends_each_valid_lane_its_slot_s_gradient(slots):
    """A dropped lane writes nothing, so it gets no gradient and adds none to
    another lane — the reference's ``.at[].set(mode="drop")``.  (Before the
    repeated value was detached, the first valid lane got its slot's
    gradient once for every dropped lane too.)"""
    rng = np.random.default_rng(len(slots))
    n = len(slots)
    vals_np = rng.standard_normal((n, 2)).astype(np.float32)
    w_np = rng.standard_normal((3, 2)).astype(np.float32)  # a cotangent per slot
    slot = torch.tensor(slots)
    vals = torch.from_numpy(vals_np).requires_grad_(True)
    dst = torch.zeros((3, 2))
    put_drop_(dst, (slot,), slot >= 0, vals)
    torch.sum(dst * torch.from_numpy(w_np)).backward()

    def ref(v):
        tgt = jnp.where(jnp.asarray(slots) >= 0, jnp.asarray(slots), 3)
        return jnp.sum(jnp.zeros((3, 2)).at[tgt].set(v, mode="drop") * w_np)

    rgrad = np.asarray(jax.grad(ref)(jnp.asarray(vals_np)))
    np.testing.assert_array_equal(vals.grad.numpy(), rgrad)
    np.testing.assert_array_equal(dst.detach().numpy(),
                                  np.asarray(jnp.zeros((3, 2)).at[jnp.where(jnp.asarray(slots) >= 0,
                                                                           jnp.asarray(slots), 3)]
                                             .set(vals_np, mode="drop")))


@pytest.mark.parametrize("shape", [(4, 8), (2, 3, 16), (1, 5, 7, 32), (32,)])
def test_rms_norm_vjp_matches_reference_f32(shape):
    rng = np.random.default_rng(sum(shape))
    x_np = rng.standard_normal(shape).astype(np.float32)
    w_np = (rng.standard_normal(shape[-1:]) * 0.1 + 1.0).astype(np.float32)
    dy_np = rng.standard_normal(shape).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda x, w: rmod.rms_norm(x, w), jnp.asarray(x_np), jnp.asarray(w_np))
    dx_ref, dw_ref = vjp(jnp.asarray(dy_np))
    x = torch.from_numpy(x_np).requires_grad_(True)
    w = torch.from_numpy(w_np).requires_grad_(True)
    y = modules.rms_norm(x, w)
    y.backward(torch.from_numpy(dy_np))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **tol)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dx_ref), **tol)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(dw_ref), **tol)


def test_rms_norm_vjp_bf16_boundary_dtypes_and_values():
    """bf16 in, bf16 cotangents out (f32 inside), each within one bf16 ulp
    of the reference's."""
    rng = np.random.default_rng(7)
    x_np = np.asarray(jnp.asarray(rng.standard_normal((3, 5, 64)), jnp.bfloat16))
    w_np = np.asarray(jnp.asarray(rng.standard_normal((64,)) * 0.1 + 1, jnp.bfloat16))
    dy_np = np.asarray(jnp.asarray(rng.standard_normal((3, 5, 64)), jnp.bfloat16))
    y_ref, vjp = jax.vjp(lambda x, w: rmod.rms_norm(x, w), jnp.asarray(x_np), jnp.asarray(w_np))
    dx_ref, dw_ref = vjp(jnp.asarray(dy_np))

    def t(a):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)

    x, w = t(x_np).requires_grad_(True), t(w_np).requires_grad_(True)
    y = modules.rms_norm(x, w)
    y.backward(t(dy_np))
    assert y.dtype == x.grad.dtype == w.grad.dtype == torch.bfloat16
    for ours, theirs in ((y, y_ref), (x.grad, dx_ref), (w.grad, dw_ref)):
        theirs = np.asarray(theirs, np.float32)
        np.testing.assert_allclose(ours.detach().float().numpy(), theirs,
                                   rtol=2 ** -7, atol=2 ** -7 * np.abs(theirs).max())


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("compression", [False, True])
def test_train_step_matches_reference(microbatches, compression):
    """Three steps from the reference's own TrainState (params, moments,
    step, residual) on one repeated batch of 4: the metrics each step, the
    parameters and the step count after."""
    rcfg, cfg = rconfigs.reduced("qwen2.5-3b"), configs.reduced("qwen2.5-3b")
    rstate = rstep.init_train_state(jax.random.PRNGKey(0), rcfg, grad_compression=compression)
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, rstate), "cpu")
    assert (state.ef is None) == (not compression)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    lr = 1e-3
    for it in range(3):
        rstate, rm = rstep.train_step(rstate, {"tokens": jnp.asarray(toks)}, rcfg,
                                      radamw.AdamWConfig(lr=lr), microbatches=microbatches)
        state, m = tstep.train_step(state, {"tokens": torch.from_numpy(toks)}, cfg,
                                    adamw.AdamWConfig(lr=lr), microbatches=microbatches)
        assert set(m) == set(rm) == {"ce", "aux", "loss", "grad_norm"}
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=LOSS_RTOL, atol=1e-7)
    assert int(state.opt.step) == int(rstate.opt.step) == 3
    for (key, p), rp in zip(paths(state.params), jax.tree.leaves(rstate.params)):
        if key.endswith("attn/bk"):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(rp), rtol=0, atol=3 * 3 * lr)
        else:
            assert _rel(p, rp) <= PARAM_TOL, (key, _rel(p, rp))
    back = train_state_to_numpy(state)
    assert [k for k, _ in paths(back)] == _jax_keys(rstate)


def test_train_step_refuses_grad_specs():
    """``grad_specs`` is taken since the mesh port (it pinned nothing before
    and was refused): without an active mesh it is the identity, with one
    microbatch and with two, bitwise.  A batch that does not divide into
    the microbatches is still refused."""
    from repro_torch.distributed import sharding as sh

    cfg = configs.reduced("qwen2.5-3b")
    batch = make_batch(cfg, 2, 8, device="cpu")
    mesh = {"data": 2, "model": 4}  # a shape-only mesh: the rules read names and sizes
    for mb in (1, 2):
        a = tstep.init_train_state(0, cfg, device="cpu")
        b = tstep.init_train_state(0, cfg, device="cpu")
        specs = sh.param_specs(b.params, cfg, mesh)
        a, ma = tstep.train_step(a, batch, cfg, adamw.AdamWConfig(), microbatches=mb)
        b, mb_ = tstep.train_step(b, batch, cfg, adamw.AdamWConfig(), microbatches=mb, grad_specs=specs)
        assert float(ma["loss"]) == float(mb_["loss"])
        assert all(torch.equal(x, y) for x, y in zip(leaves(a.params), leaves(b.params)))
    state = tstep.init_train_state(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tstep.train_step(state, make_batch(cfg, 3, 8, device="cpu"), cfg, adamw.AdamWConfig(),
                         microbatches=2)


def test_pallas_attention_is_refused_under_grad_in_both_packages():
    """Neither K13 nor the reference's Pallas kernel has a backward: a train
    step under ``attention_impl="pallas"`` raises in both packages, and the
    port's forward under ``torch.no_grad()`` still runs K13's path."""
    rcfg = dataclasses.replace(rconfigs.reduced("qwen1.5-0.5b", n_layers=2), attention_impl="pallas")
    cfg = dataclasses.replace(configs.reduced("qwen1.5-0.5b", n_layers=2), attention_impl="pallas")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    rstate = rstep.init_train_state(jax.random.PRNGKey(0), rcfg)
    with pytest.raises(Exception):
        rstep.train_step(rstate, {"tokens": jnp.asarray(toks)}, rcfg, radamw.AdamWConfig())
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, rstate), "cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        tstep.train_step(state, {"tokens": torch.from_numpy(toks)}, cfg, adamw.AdamWConfig())
    with torch.no_grad():
        logits, _ = transformer.forward(state.params, torch.from_numpy(toks), cfg)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "dbrx-132b", "seamless-m4t-large-v2", "jamba-v0.1-52b"])
def test_remat_on_and_off_are_bitwise_equal(arch):
    """``cfg.remat`` checkpoints each period (and each encoder layer): the
    loss and every gradient are the same bits either way."""
    out = []
    for remat in (False, True):
        cfg = configs.reduced(arch, remat=remat)
        state = tstep.init_train_state(0, cfg, device="cpu")
        batch = make_batch(cfg, 2, 16, seed=3, device="cpu")
        loss, _ = tstep.loss_fn(state.params, batch, cfg)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves(state.params))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_forward_unbinds_each_stacked_leaf_once():
    """Each stacked leaf's gradient arrives as one stack (one unbind a leaf
    per forward), not as one zero-filled stack per period."""
    cfg = configs.reduced("qwen2.5-3b", n_layers=4)
    state = tstep.init_train_state(0, cfg, device="cpu")
    loss, _ = tstep.loss_fn(state.params, make_batch(cfg, 2, 8, device="cpu"), cfg)
    seen, nodes = set(), []
    todo = [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        nodes.append(fn)
        todo.extend(nxt for nxt, _ in fn.next_functions)

    def from_leaf(fn):  # a node that reads a parameter directly
        return any(nxt is not None and nxt.name() == "torch::autograd::AccumulateGrad"
                   for nxt, _ in fn.next_functions)

    n_stacked = len(leaves(state.params["layers"]))
    assert sum(fn.name().startswith("UnbindBackward") and from_leaf(fn) for fn in nodes) == n_stacked
    assert not any(fn.name().startswith("SelectBackward") and from_leaf(fn) for fn in nodes)


def test_masked_loss_ignores_padding():
    """Mirror of ``tests/train/test_loss_mask.py``, on the reference's
    parameters and tokens, against the reference's losses."""
    rcfg, cfg, rparams, params = _pair("qwen2.5-3b")
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, cfg.vocab_size, jnp.int32))
    full = np.ones((2, 16), bool)
    half = full.copy()
    half[:, 8:] = False

    def both(batch):
        theirs, _ = rstep.loss_fn(rparams, {k: jnp.asarray(v) for k, v in batch.items()}, rcfg)
        with torch.no_grad():
            ours, _ = tstep.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
        np.testing.assert_allclose(float(ours), float(theirs), rtol=LOSS_RTOL)
        return float(ours)

    l_full = both({"tokens": toks, "loss_mask": full})
    np.testing.assert_allclose(l_full, both({"tokens": toks}), rtol=1e-6)
    l_half = both({"tokens": toks, "loss_mask": half})
    dirty = toks.copy()
    dirty[:, 9:] = 3  # targets 9.. are masked out (shifted by one)
    with torch.no_grad():
        l_dirty, _ = tstep.loss_fn(params, {"tokens": torch.from_numpy(dirty),
                                            "loss_mask": torch.from_numpy(half)}, cfg)
    assert abs(l_half - l_full) > 1e-6  # the mask selects
    # masked targets do not count; only the inputs past 8 change the hidden
    # states of positions that are themselves masked
    np.testing.assert_allclose(float(l_dirty), l_half, rtol=1e-6)
    zero = np.zeros((2, 16), bool)
    l_zero = both({"tokens": toks, "loss_mask": zero})  # the denominator is at least 1
    assert l_zero == 0.0


def test_packer_to_train_step_end_to_end():
    """Mirror of the reference's packer test: both packers' batches (bitwise
    equal) through both losses, then one port train step."""
    rcfg, cfg, rparams, params = _pair("qwen2.5-3b")
    rp, p = RPacker(nblocks=2, b0=8), Packer(nblocks=2, b0=8, device="cpu")
    for d in ([1, 2, 3, 4], [5, 6], [7, 8, 9], list(range(10, 50))):
        rp.add_document(d)
        p.add_document(d)
    rbatch, batch = rp.pack(batch=2, seq=32), p.pack(batch=2, seq=32)
    for k in rbatch:
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(rbatch[k]))
    theirs, _ = rstep.loss_fn(rparams, rbatch, rcfg)
    ours, _ = tstep.loss_fn(params, batch, cfg)
    np.testing.assert_allclose(float(ours), float(theirs), rtol=LOSS_RTOL)
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, rstep.init_train_state(
        jax.random.PRNGKey(0), rcfg)), "cpu")
    state, m = tstep.train_step(state, batch, cfg, adamw.AdamWConfig())
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_train_step_reduces_loss_and_stays_finite(arch):
    """Mirror of ``tests/models/test_arch_smoke.py``'s train test: three
    steps on a repeated batch lower the loss; parameters stay finite and
    keep their dtypes; moments are f32."""
    cfg = configs.reduced(arch)
    state = tstep.init_train_state(0, cfg, device="cpu")
    dtypes = [p.dtype for p in leaves(state.params)]
    step = tstep.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    batch = make_batch(cfg, 2, 32, device="cpu")
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)), f"{arch}: loss diverged {losses}"
    assert losses[-1] < losses[0], f"{arch}: no learning on repeated batch {losses}"
    assert all(bool(torch.isfinite(p.float()).all()) for p in leaves(state.params))
    assert [p.dtype for p in leaves(state.params)] == dtypes
    assert all(p.requires_grad for p in leaves(state.params))
    assert all(m.dtype == torch.float32 for m in leaves(state.opt.m) + leaves(state.opt.v))
