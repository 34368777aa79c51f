"""Port of the Mamba-2 SSD layer (``repro.models.ssm``): the chunked block
with and without a resumed state, the one-token decode step, and the
parameter tree, on the same seeded numpy inputs and the reference's own
parameters (jamba's and mamba2's reduced shapes: d_model 64, 8 heads of
16, d_state 16, chunk 8).  Outputs and states are held to rtol = atol =
2e-3, the tolerance of ``tests/test_torch_models.py``; the port's chunked
resume is held bitwise to its own monolithic pass at chunk multiples, the
property chunked prefill relies on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import ssm as rssm
from repro_torch import configs
from repro_torch.models import ssm

TOL = dict(rtol=2e-3, atol=2e-3)
ARCHS = ("jamba-v0.1-52b", "mamba2-2.7b")


def _setup(arch, seed=0):
    rcfg, cfg = rconfigs.reduced(arch), configs.reduced(arch)
    rp = rssm.init_mamba(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    # non-trivial decay, skip and bias, so every term of the scan shows
    rng = np.random.default_rng(seed + 100)
    nh = rp["A_log"].shape[0]
    rp = dict(rp, A_log=jnp.asarray(rng.uniform(-1, 1, nh).astype(np.float32)),
              D=jnp.asarray(rng.uniform(0.5, 1.5, nh).astype(np.float32)),
              dt_bias=jnp.asarray(rng.uniform(-1, 0.5, nh).astype(np.float32)),
              conv_b=jnp.asarray(rng.standard_normal(rp["conv_b"].shape).astype(np.float32) * 0.1))
    return rcfg, cfg, rp, {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}


def _x(seed, B, L, D):
    return np.random.default_rng(seed).standard_normal((B, L, D)).astype(np.float32)


def _state(seed, cfg, B):
    st = ssm.init_mamba_state(cfg, B, torch.float32, "cpu")
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(st.conv.shape).astype(np.float32),
            rng.standard_normal(st.ssd.shape).astype(np.float32) * 0.5)


def _close(ours, theirs):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("L", [2, 8, 20])
def test_mamba_block_matches_reference(arch, L):
    """L = 2 is shorter than the conv window, 8 one chunk, 20 a padded tail."""
    rcfg, cfg, rp, p = _setup(arch)
    x = _x(L, 2, L, cfg.d_model)
    out, st = ssm.mamba_block(p, torch.from_numpy(x), cfg, return_state=True)
    rout, rst = rssm.mamba_block(rp, jnp.asarray(x), rcfg, return_state=True)
    _close(out, rout)
    _close(st.conv, rst.conv)
    _close(st.ssd, rst.ssd)
    _close(ssm.mamba_block(p, torch.from_numpy(x), cfg), rout)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("L", [3, 8, 11])
def test_mamba_block_resumed_from_a_state_matches_reference(arch, L):
    rcfg, cfg, rp, p = _setup(arch, seed=1)
    x = _x(L + 50, 2, L, cfg.d_model)
    conv, ssd = _state(L, cfg, 2)
    out, st = ssm.mamba_block(p, torch.from_numpy(x), cfg,
                              ssm.MambaState(torch.from_numpy(conv), torch.from_numpy(ssd)),
                              return_state=True)
    rout, rst = rssm.mamba_block(rp, jnp.asarray(x), rcfg,
                                 rssm.MambaState(jnp.asarray(conv), jnp.asarray(ssd)),
                                 return_state=True)
    _close(out, rout)
    _close(st.conv, rst.conv)
    _close(st.ssd, rst.ssd)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_decode_step_matches_reference(arch):
    rcfg, cfg, rp, p = _setup(arch, seed=2)
    x = _x(7, 3, 1, cfg.d_model)
    conv, ssd = _state(8, cfg, 3)
    out, st = ssm.mamba_decode_step(p, torch.from_numpy(x),
                                    ssm.MambaState(torch.from_numpy(conv), torch.from_numpy(ssd)), cfg)
    rout, rst = rssm.mamba_decode_step(rp, jnp.asarray(x),
                                       rssm.MambaState(jnp.asarray(conv), jnp.asarray(ssd)), rcfg)
    _close(out, rout)
    _close(st.conv, rst.conv)
    _close(st.ssd, rst.ssd)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("splits", [(32, 8), (16, 16, 8), (8, 8, 8, 8, 8), (24, 3)])
def test_chunked_resume_equals_monolithic(arch, splits):
    """Chunks at multiples of chunk_size (the last one any length) resumed
    from the state give the monolithic pass's outputs and final state, bit
    for bit; the first chunk runs from no state."""
    _, cfg, _, p = _setup(arch, seed=3)
    L = sum(splits)
    x = torch.from_numpy(_x(9, 2, L, cfg.d_model))
    want, want_st = ssm.mamba_block(p, x, cfg, return_state=True)
    outs, st, t0 = [], None, 0
    for n in splits:
        y, st = ssm.mamba_block(p, x[:, t0:t0 + n], cfg, st, return_state=True)
        outs.append(y)
        t0 += n
    assert torch.equal(torch.cat(outs, dim=1), want)
    assert torch.equal(st.conv, want_st.conv)
    assert torch.equal(st.ssd, want_st.ssd)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_continue_the_block(arch):
    """A prefill's state, then decode steps one token at a time, against
    the block over the whole sequence."""
    _, cfg, _, p = _setup(arch, seed=4)
    x = torch.from_numpy(_x(10, 2, 13, cfg.d_model))
    want = ssm.mamba_block(p, x, cfg)
    got, st = ssm.mamba_block(p, x[:, :9], cfg, return_state=True)
    outs = [got]
    for t in range(9, 13):
        y, st = ssm.mamba_decode_step(p, x[:, t:t + 1], st, cfg)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_mamba_has_the_reference_tree_and_f32_leaves(arch):
    cfg = configs.reduced(arch, dtype="bfloat16", param_dtype="bfloat16")
    rcfg = rconfigs.reduced(arch, dtype="bfloat16", param_dtype="bfloat16")
    ours = ssm.init_mamba(torch.Generator().manual_seed(0), cfg, torch.bfloat16, lead=(2,))
    theirs = rssm.init_mamba(jax.random.PRNGKey(0), rcfg, jnp.bfloat16)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert tuple(ours[k].shape) == (2, *v.shape), k
        assert str(ours[k].dtype).split(".")[-1] == str(v.dtype), k
    assert torch.all(ours["D"] == 1) and torch.all(ours["A_log"] == 0) and torch.all(ours["conv_b"] == 0)
