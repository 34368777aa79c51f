"""Port of the MoE layer (``repro.models.moe``): expert capacity, the
routing and parallel-insertion packing under every insertion method
(``scan``; ``atomic``; ``tile``, K1; ``mxu``, K2 — each reference method in
its CPU form, Pallas in interpret mode), and the layer's output and aux
loss, on the same seeded numpy inputs and the reference's own parameters.

Integer and data-movement results are held bitwise: experts, offsets,
slots, the packed buffer.  The gates are bitwise given the reference's
router probabilities (top-k and the renormalisation are exact); end to end
they differ by float rounding, because XLA's CPU matmul and ``exp`` round
differently from torch's, so there they are held within 1e-6, as are the
two means behind the aux loss (their sums run in another order).  The layer
output and aux loss are held to rtol = atol = 2e-3, the tolerance of
``tests/test_torch_models.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.insertion import insertion_offsets as r_insertion_offsets
from repro.models import moe as rmoe
from repro_torch import configs
from repro_torch.kernels import common
from repro_torch.models import moe

TOL = dict(rtol=2e-3, atol=2e-3)
METHODS = ("scan", "atomic", "tile", "mxu")


def _cfgs(arch="dbrx-132b", **moe_over):
    rcfg, cfg = rconfigs.reduced(arch), configs.reduced(arch)
    if moe_over:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, **moe_over))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    return rcfg, cfg


def _params(rcfg, seed=0):
    rp = rmoe.init_moe(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    return rp, {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}


def _x(rng, T, D):
    return rng.standard_normal((T, D)).astype(np.float32)


def _eq(ours: torch.Tensor, theirs) -> None:
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("ggarray_capacity", [False, True])
def test_expert_capacity_matches_reference(ggarray_capacity):
    for n_experts, top_k, b0, factor in [(4, 2, 4, 1.25), (16, 4, 128, 1.25), (16, 1, 8, 1.0),
                                         (8, 2, 1, 2.0), (16, 4, 2048, 0.5)]:
        over = dict(n_experts=n_experts, top_k=top_k, capacity_b0=b0, capacity_factor=factor,
                    ggarray_capacity=ggarray_capacity)
        rcfg, cfg = _cfgs(**over)
        for n in [1, 2, 3, 7, 8, 31, 32, 100, 1000, 7168, 28672]:
            assert moe.expert_capacity(cfg.moe, n) == rmoe.expert_capacity(rcfg.moe, n), (over, n)


def test_top_k_gates_bitwise_on_the_reference_probs():
    """Ties included: the lower expert first, as ``jax.lax.top_k``."""
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(16), size=64).astype(np.float32)
    probs[:8, 3] = probs[:8, 9] = probs[:8].max(axis=1)  # a tie at the top
    probs[8:16, 5] = probs[8:16, 1]  # ties further down
    for k in (1, 2, 4):
        gate, expert = moe.top_k_gates(torch.from_numpy(probs), k)
        rg, re = jax.lax.top_k(jnp.asarray(probs), k)
        rg = rg / jnp.clip(jnp.sum(rg, axis=-1, keepdims=True), 1e-9)
        _eq(expert, re)
        _eq(gate, rg)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_route_and_pack_matches_reference(method, factor):
    """factor 0.5 drops tokens (rank >= C), so the slots depend on every
    rank being the reference's."""
    rcfg, cfg = _cfgs(capacity_factor=factor)
    rcfg = dataclasses.replace(rcfg, insertion_method=method)
    cfg = dataclasses.replace(cfg, insertion_method=method)
    rp, p = _params(rcfg)
    rng = np.random.default_rng(1)
    T, E, k = 24, cfg.moe.n_experts, cfg.moe.top_k
    x = _x(rng, T, cfg.d_model)
    C = moe.expert_capacity(cfg.moe, T)
    common.reset_launch_counts()
    buf, slot, gate, (density, router_prob) = moe._route_and_pack(p, torch.from_numpy(x), cfg, C)
    assert common.launch_counts() == {n: 0 for n in common.KERNELS}  # CPU: plain versions
    rbuf, rslot, rgate, (rdensity, rrouter_prob) = rmoe._route_and_pack(rp, jnp.asarray(x), rcfg, C)
    _eq(slot, rslot)
    _eq(buf, rbuf)
    np.testing.assert_allclose(density.numpy(), np.asarray(rdensity), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gate.numpy(), np.asarray(rgate), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(router_prob.numpy(), np.asarray(rrouter_prob), rtol=1e-6, atol=1e-6)
    # the offsets and experts behind those slots, against the reference's scan
    _, _, expert = moe.route(p, torch.from_numpy(x), cfg)
    rprobs = jax.nn.softmax(jnp.asarray(x) @ rp["router"], axis=-1)
    _, rexpert = jax.lax.top_k(rprobs, k)
    _eq(expert, rexpert)
    _, _, offsets, assign = moe.pack(torch.from_numpy(x), expert, cfg, C)
    rassign = jax.nn.one_hot(rexpert.reshape(-1), E, dtype=jnp.int32).T.astype(bool)
    roffsets, _ = r_insertion_offsets(rassign, method=method)
    _eq(assign, rassign)
    _eq(offsets[assign], np.asarray(roffsets)[np.asarray(rassign)])
    if factor < 1:
        assert (slot < 0).any(), "the case must drop tokens"
    assert (slot >= 0).any()


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("method", ["scan", "mxu"])
def test_moe_block_matches_reference(arch, method):
    rcfg, cfg = _cfgs(arch)
    rcfg = dataclasses.replace(rcfg, insertion_method=method)
    cfg = dataclasses.replace(cfg, insertion_method=method)
    rp, p = _params(rcfg, seed=2)
    x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    out, aux = moe.moe_block(p, torch.from_numpy(x), cfg)
    rout, raux = rmoe.moe_block(rp, jnp.asarray(x), rcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **TOL)
    np.testing.assert_allclose(float(aux), float(raux), **TOL)
    assert aux.dtype == torch.float32


@pytest.mark.parametrize("ggarray_capacity", [False, True])
def test_pack_drops_exactly_each_experts_overflow(ggarray_capacity):
    """Each expert keeps its first C assignments in token order and drops
    the rest; the kept rows land in distinct slots of its own segment."""
    rcfg, cfg = _cfgs(ggarray_capacity=ggarray_capacity, capacity_factor=0.75)
    _, p = _params(rcfg, seed=4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((40, cfg.d_model)).astype(np.float32))
    C = moe.expert_capacity(cfg.moe, 40)
    _, _, expert = moe.route(p, x, cfg)
    buf, slot, offsets, assign = moe.pack(x, expert, cfg, C)
    counts = assign.sum(dim=1)
    assert int((slot < 0).sum()) == int(torch.clamp(counts - C, min=0).sum())
    flat = expert.reshape(-1)
    kept = slot >= 0
    assert torch.equal(slot[kept] // C, flat[kept])
    assert len(set(slot[kept].tolist())) == int(kept.sum())
    assert torch.equal(buf[slot[kept]], torch.repeat_interleave(x, cfg.moe.top_k, dim=0)[kept])


def test_init_moe_keeps_the_router_f32_and_draws_per_expert():
    cfg = configs.reduced("dbrx-132b", dtype="bfloat16", param_dtype="bfloat16")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16, lead=(3,))
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    assert p["router"].dtype == torch.float32 and p["router"].shape == (3, d, E)
    assert p["w_gate"].dtype == torch.bfloat16 and p["w_gate"].shape == (3, E, d, f)
    assert p["w_down"].shape == (3, E, f, d)
    # each (period, expert) slice is its own draw, scaled by 1/sqrt(fan_in)
    std = p["w_gate"].float().std(dim=(2, 3))
    np.testing.assert_allclose(std.numpy(), d ** -0.5, rtol=0.1)
    assert not torch.equal(p["w_gate"][0, 0], p["w_gate"][0, 1])
