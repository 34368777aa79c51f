"""Port of the synthetic data (``repro.data.synthetic``) and the frontend
stubs (``repro.models.frontends``).  JAX's PRNG does not carry over, so
the values differ from the reference's; the keys, shapes and dtypes are
held to the reference's for every registered architecture, and a batch is
a pure function of (seed, step)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import synthetic as rsynthetic
from repro_torch import configs
from repro_torch.data import synthetic
from repro_torch.models import frontends


def _spec(spec: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in spec.items()}


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_batch_spec_and_make_batch_match_the_reference(arch):
    cfg, rcfg = configs.reduced(arch), rconfigs.reduced(arch)
    want = _spec(rsynthetic.batch_spec(rcfg, 3, 16))
    assert _spec(synthetic.batch_spec(cfg, 3, 16)) == want
    assert _spec(synthetic.make_batch(cfg, 3, 16, device="cpu")) == want
    assert _spec(rsynthetic.make_batch(rcfg, 3, 16)) == want
    # the full-size config's dtype (bf16) too
    full, rfull = configs.get(arch), rconfigs.get(arch)
    assert _spec(synthetic.batch_spec(full, 2, 8)) == _spec(rsynthetic.batch_spec(rfull, 2, 8))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "seamless-m4t-large-v2", "internvl2-26b"])
def test_make_batch_is_a_function_of_seed_and_step(arch):
    cfg = configs.reduced(arch)
    a = synthetic.make_batch(cfg, 4, 32, seed=1, step=5, device="cpu")
    b = synthetic.make_batch(cfg, 4, 32, seed=1, step=5, device="cpu")
    c = synthetic.make_batch(cfg, 4, 32, seed=1, step=6, device="cpu")
    d = synthetic.make_batch(cfg, 4, 32, seed=2, step=5, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k]) and not torch.equal(a[k], d[k])
    toks = a["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    for k in a.keys() - {"tokens"}:
        assert 0.01 < float(a[k].float().std()) < 0.03  # N(0, 0.02²)


def test_frontend_stubs_have_the_reference_shapes():
    cfg = configs.reduced("internvl2-26b")
    gen = torch.Generator().manual_seed(0)
    pe = frontends.synthetic_prefix_embeds(gen, cfg, 3)
    assert pe.shape == (3, cfg.n_prefix_embeds, cfg.d_model) and pe.dtype == torch.float32
    fr = frontends.synthetic_frames(gen, configs.reduced("seamless-m4t-large-v2"), 2, 24,
                                    dtype=torch.bfloat16)
    assert fr.shape == (2, 24, 64) and fr.dtype == torch.bfloat16
    assert np.isfinite(pe.numpy()).all()
    assert str(jnp.dtype(rconfigs.reduced("internvl2-26b").dtype)) == str(pe.dtype).split(".")[-1]


@pytest.mark.parametrize("entry", ["make_batch", "init_mamba_state", "init_decode_caches",
                                   "Engine", "BatchEngine"])
def test_family_entry_points_need_a_card_unless_asked_for_cpu(entry):
    """The slice's entry points default to the card, as the earlier ones do
    (``tests/test_torch_import.py``): without one they raise, naming
    ``device='cpu'``."""
    from repro_torch.models import ssm, transformer
    from repro_torch.serving import steps
    from repro_torch.serving.engine import BatchEngine, Engine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    jamba, mamba = configs.reduced("jamba-v0.1-52b"), configs.reduced("mamba2-2.7b")
    make = {
        "make_batch": lambda **kw: synthetic.make_batch(jamba, 2, 8, **kw)["tokens"],
        "init_mamba_state": lambda **kw: ssm.init_mamba_state(jamba, 2, torch.float32, **kw).ssd,
        "init_decode_caches": lambda **kw: steps.init_decode_caches(jamba, 2, 9, **kw)[0]["conv"],
        "Engine": lambda **kw: Engine(transformer.init_params(mamba, torch.Generator()), mamba, **kw),
        "BatchEngine": lambda **kw: BatchEngine(transformer.init_params(jamba, torch.Generator()), jamba,
                                                **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu").device.type == "cpu"
