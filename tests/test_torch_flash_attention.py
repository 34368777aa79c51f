"""Port of flash attention (K13, ``repro.kernels.flash_attention``): the
port's plain version — what its wrapper runs on the CPU — against the
reference's oracle (``ref.attention``) and its Pallas kernel in interpret
mode, on the shapes and tolerances of
``tests/kernels/test_attention_kernels.py``.  The CUDA kernel itself runs
only on a card (``chip_smoke.py`` holds it against this plain version)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as rops
from repro.kernels.flash_attention import ref as rref
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import kernel as k_fa
from repro_torch.kernels.flash_attention import ops, ref

SHAPES = [(2, 128, 128, 64, 1), (4, 256, 256, 32, 2), (2, 64, 128, 128, 1)]


def _inputs(rng, BH, Sq, Skv, D, group):
    q = rng.standard_normal((BH, Sq, D)).astype(np.float32)
    k = rng.standard_normal((BH // group, Skv, D)).astype(np.float32)
    v = rng.standard_normal((BH // group, Skv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BH,Sq,Skv,D,group", SHAPES)
def test_plain_version_matches_reference_oracle_and_kernel(causal, BH, Sq, Skv, D, group):
    rng = np.random.default_rng(BH * Sq + D)
    q, k, v = _inputs(rng, BH, Sq, Skv, D, group)
    ours = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), group=group, causal=causal)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    oracle = rref.attention(jq, jk, jv, group=group, causal=causal)
    kernel = rops.flash_attention(jq, jk, jv, group=group, causal=causal, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(oracle), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(kernel), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtypes_match_reference(dtype):
    rng = np.random.default_rng(7)
    arrs = [np.asarray(jnp.asarray(rng.standard_normal((2, 128, 64)), dtype)) for _ in range(3)]
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    theirs = rops.flash_attention(jq, jk, jv, causal=True, bq=64, bk=64, interpret=True)
    if dtype == "bfloat16":
        ts = [torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16) for a in arrs]
    else:
        ts = [torch.from_numpy(np.array(a)) for a in arrs]
    ours = ops.flash_attention(*ts, causal=True, bq=64, bk=64)
    assert ours.dtype == ts[0].dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32), rtol=tol, atol=tol)


def test_strided_bhsd_entry_equals_the_3d_one():
    """The model's entry takes (B, H, S, D) views of (B, S, H, D) tensors and
    writes a strided output; it computes what the (BH, S, D) entry does."""
    rng = np.random.default_rng(5)
    B, S, H, KH, D = 2, 64, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KH, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KH, D)).astype(np.float32))
    out = torch.zeros_like(q)
    ops.flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             out.transpose(1, 2), group=H // KH, causal=True)
    flat = ops.flash_attention(q.transpose(1, 2).reshape(B * H, S, D), k.transpose(1, 2).reshape(B * KH, S, D),
                               v.transpose(1, 2).reshape(B * KH, S, D), group=H // KH, causal=True)
    torch.testing.assert_close(out.transpose(1, 2).reshape(B * H, S, D), flat, rtol=0, atol=0)


@pytest.mark.parametrize("Sq,Skv", [(300, 300), (256, 300), (512, 320)])
def test_unpadded_lengths_raise_as_the_reference(Sq, Skv):
    q = torch.zeros((1, Sq, 16))
    k = torch.zeros((1, Skv, 16))
    with pytest.raises(ValueError, match="unpadded seq"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="unpadded seq"):
        rops.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(k.numpy()),
                             interpret=True)


def test_cuda_launcher_refuses_other_tensors_and_cpu_launches_nothing():
    common.reset_launch_counts()
    x = torch.zeros((1, 2, 8, 16))
    ops.flash_attention(x[0], x[0], x[0])
    assert common.launch_counts()["flash_attention"] == 0
    meta = torch.zeros((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        ops.flash_attention_bhsd(meta, meta, meta, torch.empty_like(meta))
    with pytest.raises(ValueError, match="expected cuda"):
        k_fa.flash_attention_cuda(x, x, x, x, group=1, causal=True, sm_scale=1.0)


def test_fully_masked_rows_read_zero_not_nan():
    """Causal with more queries than keys leaves no row fully masked; the
    plain version never divides by zero either way (l ≥ 1e-30 in the
    kernel, exact softmax in the plain version)."""
    rng = np.random.default_rng(2)
    q, k, v = _inputs(rng, 2, 64, 64, 32, 1)
    out = ref.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True)
    assert torch.isfinite(out).all()
