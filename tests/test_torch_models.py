"""Port of the model layers (``repro.models``): the building blocks, the MLP,
the four attention implementations and the decoder's forward, each fed the
same seeded numpy inputs (and, for the stacks, the reference's own
parameters carried over by ``convert.params_from_numpy``) on both sides.
Float results are held to rtol = atol = 2e-3, the tolerance of the
reference's own attention tests (``tests/models/test_attention_impls.py``);
in f32 the two packages differ only in the order of summation."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import encdec as rencdec
from repro.models import mlp as rmlp
from repro.models import modules as rmod
from repro.models import transformer as rtf
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention, encdec, mlp, modules, transformer

TOL = dict(rtol=2e-3, atol=2e-3)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _tree(tree, leaf):
    if isinstance(tree, dict):
        return {k: _tree(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, leaf) for v in tree]
    return leaf(tree)


def _close(ours, theirs, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), **(tol or TOL))


def test_rms_norm_rope_embed_unembed_match_reference():
    rng = np.random.default_rng(0)
    x, w = _np(rng, 2, 5, 3, 16), _np(rng, 16)
    _close(modules.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           rmod.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    pos = np.arange(5)[None, :] + np.array([[0], [7]])
    cos, sin = modules.rope(torch.from_numpy(pos), 16, 1e6)
    rcos, rsin = rmod.rope(jnp.asarray(pos), 16, 1e6)
    _close(cos, rcos)
    _close(sin, rsin)
    _close(modules.apply_rope(torch.from_numpy(x), cos, sin), rmod.apply_rope(jnp.asarray(x), rcos, rsin))
    table, toks = _np(rng, 11, 16), rng.integers(0, 11, (2, 4))
    _close(modules.embed(torch.from_numpy(table), torch.from_numpy(toks)),
           rmod.embed(jnp.asarray(table), jnp.asarray(toks)), rtol=0, atol=0)
    _close(modules.unembed(torch.from_numpy(x[..., 0, :]), torch.from_numpy(table)),
           rmod.unembed(jnp.asarray(x[..., 0, :]), jnp.asarray(table)))


def test_bf16_rms_norm_rounds_like_reference():
    rng = np.random.default_rng(1)
    x = np.array(jnp.asarray(_np(rng, 4, 64), jnp.bfloat16))
    w = np.array(jnp.asarray(_np(rng, 64), jnp.bfloat16))
    ours = modules.rms_norm(torch.from_numpy(x.view(np.int16)).view(torch.bfloat16),
                            torch.from_numpy(w.view(np.int16)).view(torch.bfloat16)).float()
    theirs = np.asarray(rmod.rms_norm(jnp.asarray(x), jnp.asarray(w)), np.float32)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-2, atol=1e-2)  # one bf16 ulp


@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu"])
def test_mlp_matches_reference(activation):
    rng = np.random.default_rng(2)
    p = rmlp.init_mlp(jax.random.PRNGKey(0), 16, 40, activation, jnp.float32)
    if activation != "swiglu":  # non-zero biases, so they are exercised
        p = dict(p, b_up=jnp.asarray(_np(rng, 40)), b_down=jnp.asarray(_np(rng, 16)))
    x = _np(rng, 2, 3, 16)
    ours = mlp.mlp_block({k: torch.from_numpy(np.asarray(v)) for k, v in p.items()},
                         torch.from_numpy(x), activation)
    _close(ours, rmlp.mlp_block(p, jnp.asarray(x), activation))


@pytest.mark.parametrize("impl", ["blockwise", "blockwise_tri", "xla", "pallas"])
@pytest.mark.parametrize("S,causal", [(32, True), (64, True), (96, True), (64, False)])
def test_attention_impls_match_reference(impl, S, causal):
    """Each impl against the reference's same impl (its Pallas kernel in
    interpret mode for ``pallas``, whose 256-tile contract needs S ≤ 256 or
    a multiple of 256 — every S here)."""
    cfg = dataclasses.replace(configs.reduced("qwen3-32b"), attention_impl=impl, attention_chunk=32)
    rcfg = dataclasses.replace(rconfigs.reduced("qwen3-32b"), attention_impl=impl, attention_chunk=32)
    rng = np.random.default_rng(S)
    B, H, KH, Dh = 2, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _np(rng, B, S, H, Dh), _np(rng, B, S, KH, Dh), _np(rng, B, S, KH, Dh)
    ours = attention.inner_attention(*(torch.from_numpy(a) for a in (q, k, v)), cfg, causal=causal)
    theirs = rattn.inner_attention(*(jnp.asarray(a) for a in (q, k, v)), rcfg, causal=causal)
    _close(ours, theirs)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-32b"])
def test_project_qkv_and_out_match_reference(arch):
    """QKV bias (qwen2.5) and qk-norm (qwen3) on the reference's parameters."""
    rcfg, cfg = rconfigs.reduced(arch), configs.reduced(arch)
    p = rattn.init_attention(jax.random.PRNGKey(3), rcfg, jnp.float32)
    rng = np.random.default_rng(3)
    p = {k: jnp.asarray(_np(rng, *v.shape)) if k.startswith("b") else v for k, v in p.items()}
    pt = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
    x = _np(rng, 2, 7, cfg.d_model)
    pos = np.arange(7)[None, :] + 3
    ours = attention.project_qkv(pt, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    theirs = rattn.project_qkv(p, jnp.asarray(x), rcfg, jnp.asarray(pos))
    for a, b in zip(ours, theirs):
        _close(a, b)
    _close(attention.project_out(pt, ours[0]), rattn.project_out(p, theirs[0]))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-32b"])
@pytest.mark.parametrize("impl", ["blockwise", "pallas"])
def test_forward_matches_reference(arch, impl):
    rcfg = dataclasses.replace(rconfigs.reduced(arch), attention_impl=impl)
    cfg = dataclasses.replace(configs.reduced(arch), attention_impl=impl)
    rparams = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    ours, aux = transformer.forward(params, torch.from_numpy(toks), cfg)
    theirs, _ = rtf.forward(rparams, jnp.asarray(toks), rcfg)
    _close(ours, theirs)
    assert float(aux) == 0.0


def test_init_params_has_the_reference_tree():
    cfg = configs.reduced("qwen2.5-3b")
    gen = torch.Generator().manual_seed(0)
    ours = transformer.init_params(cfg, gen)
    theirs = rtf.init_params(jax.random.PRNGKey(0), rconfigs.reduced("qwen2.5-3b"))

    def shapes(tree, leaf):
        if isinstance(tree, dict):
            return {k: shapes(v, leaf) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [shapes(v, leaf) for v in tree]
        return leaf(tree)

    assert shapes(ours, lambda t: tuple(t.shape)) == shapes(theirs, lambda a: tuple(a.shape))
    assert shapes(ours, lambda t: str(t.dtype).split(".")[-1]) == shapes(theirs, lambda a: str(a.dtype))
    assert torch.all(ours["layers"][0]["attn"]["bq"] == 0)
    assert torch.all(ours["final_norm"] == 1)


def test_bf16_params_travel_as_bits():
    cfg = configs.reduced("qwen2.5-3b", dtype="bfloat16", param_dtype="bfloat16")
    rparams = rtf.init_params(jax.random.PRNGKey(1), rconfigs.reduced(
        "qwen2.5-3b", dtype="bfloat16", param_dtype="bfloat16"))
    as_np = jax.tree.map(np.asarray, rparams)
    as_bits = jax.tree.map(lambda a: a.view(np.uint16), as_np)
    a = params_from_numpy(cfg, as_np, "cpu")
    b = params_from_numpy(cfg, as_bits, "cpu")
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["embed"].view(torch.int16), b["embed"].view(torch.int16))
    np.testing.assert_array_equal(a["embed"].view(torch.int16).numpy().view(np.uint16),
                                  as_bits["embed"])
    with pytest.raises(TypeError):
        params_from_numpy(configs.reduced("qwen2.5-3b"), as_np, "cpu")


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_every_family_forward_matches_reference(arch):
    """Every registered family — dense, MoE (routed by the insertion scan),
    Mamba, the Jamba hybrid, encoder–decoder (memory from each package's
    own ``encode``) and prefix embeddings — logits and aux loss against the
    reference's ``forward`` on its own parameters and the same inputs."""
    rcfg, cfg = rconfigs.reduced(arch), configs.reduced(arch)
    rparams = rtf.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    kw, rkw = {}, {}
    if cfg.n_prefix_embeds:
        pe = _np(rng, 2, cfg.n_prefix_embeds, cfg.d_model) * 0.02
        kw["prefix_embeds"], rkw["prefix_embeds"] = torch.from_numpy(pe), jnp.asarray(pe)
    if cfg.n_enc_layers:
        frames = _np(rng, 2, 24, cfg.d_model) * 0.02
        kw["memory"] = encdec.encode(params["encoder"], torch.from_numpy(frames), cfg)
        rkw["memory"] = rencdec.encode(rparams["encoder"], jnp.asarray(frames), rcfg)
        _close(kw["memory"], rkw["memory"])
    ours, aux = transformer.forward(params, torch.from_numpy(toks), cfg, **kw)
    theirs, raux = rtf.forward(rparams, jnp.asarray(toks), rcfg, **rkw)
    assert ours.shape == (2, 32 + cfg.n_prefix_embeds, cfg.padded_vocab)
    _close(ours, theirs)
    np.testing.assert_allclose(float(aux), float(raux), **TOL)
    assert (float(aux) > 0) == (cfg.moe is not None and "attn" in cfg.layout
                                and any(cfg.is_moe_layer(i) and k == "attn"
                                        for i, k in enumerate(cfg.layout)))


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_init_params_tree_matches_reference_for_every_arch(arch):
    """Slot trees (``mamba``; ``moe`` or ``mlp``; ``cross_norm``/``cross``),
    the encoder, shapes and dtypes — f32 router and SSM leaves in bf16."""
    cfg = configs.reduced(arch, dtype="bfloat16", param_dtype="bfloat16")
    rcfg = rconfigs.reduced(arch, dtype="bfloat16", param_dtype="bfloat16")
    ours = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    theirs = jax.eval_shape(lambda: rtf.init_params(jax.random.PRNGKey(0), rcfg))
    assert _tree(ours, lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1])) == \
        _tree(theirs, lambda a: (tuple(a.shape), str(a.dtype)))


def test_f32_leaves_travel_inside_a_bf16_tree():
    """The router and A_log / D / dt_bias are f32 in a bf16 model (the
    reference's own dtypes); any other f32 leaf is refused."""
    for arch, slot, sub, name in [("dbrx-132b", 0, "moe", "router"), ("jamba-v0.1-52b", 0, "mamba", "A_log"),
                                  ("jamba-v0.1-52b", 0, "mamba", "dt_bias"), ("mamba2-2.7b", 0, "mamba", "D")]:
        cfg = configs.reduced(arch, dtype="bfloat16", param_dtype="bfloat16")
        rcfg = rconfigs.reduced(arch, dtype="bfloat16", param_dtype="bfloat16")
        as_np = jax.tree.map(np.asarray, rtf.init_params(jax.random.PRNGKey(2), rcfg))
        got = params_from_numpy(cfg, as_np, "cpu")
        assert got["layers"][slot][sub][name].dtype == torch.float32
        np.testing.assert_array_equal(got["layers"][slot][sub][name].numpy(), as_np["layers"][slot][sub][name])
        assert got["embed"].dtype == torch.bfloat16
        bad = jax.tree.map(lambda a: a, as_np)
        bad["layers"][slot][sub][name] = as_np["layers"][slot][sub][name].astype(np.float16)
        with pytest.raises(TypeError, match=name):
            params_from_numpy(cfg, bad, "cpu")
    cfg = configs.reduced("qwen2.5-3b", dtype="bfloat16", param_dtype="bfloat16")
    as_np = jax.tree.map(np.asarray, rtf.init_params(jax.random.PRNGKey(3), rconfigs.reduced(
        "qwen2.5-3b", dtype="bfloat16", param_dtype="bfloat16")))
    as_np["final_norm"] = as_np["final_norm"].astype(np.float32)
    with pytest.raises(TypeError, match="final_norm"):
        params_from_numpy(cfg, as_np, "cpu")
