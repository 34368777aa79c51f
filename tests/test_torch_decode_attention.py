"""Port of flash-decode (K14, ``kernels/decode_attention``), held against
``repro.kernels.decode_attention`` (its Pallas kernel in interpret mode on
the CPU) within the reference test's 2e-3 (f32; another summation order) and
2e-2 (bf16).  Length 0 is held against the reference's kernel (zeros), not
its oracle (NaN).  The token-major (B, S, KH, D) cache goes in as a strided
view and gives the same result."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as ref_ops
from repro.kernels.decode_attention import ref as ref_ref
from repro_torch import convert
from repro_torch.kernels.decode_attention import kernel, ops, ref

SHAPES = [(2, 8, 2, 256, 64), (1, 4, 4, 512, 32), (3, 16, 2, 128, 128)]


def _qkv(B, H, KH, S, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(dtype)
    k = rng.standard_normal((B, KH, S, D)).astype(dtype)
    v = rng.standard_normal((B, KH, S, D)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("B,H,KH,S,D", SHAPES)
def test_decode_matches_reference_partial_lengths(B, H, KH, S, D):
    q, k, v = _qkv(B, H, KH, S, D, B * 1000 + S + D)
    lengths = np.random.default_rng(S).integers(1, S + 1, (B,)).astype(np.int32)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(lengths), bk=64).numpy()
    want = ref_ops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lengths), bk=64)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)
    oracle = ref_ref.decode_attention(jnp.asarray(q).reshape(B, KH, H // KH, D), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(lengths)).reshape(B, H, D)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-3, atol=2e-3)


def test_decode_ignores_dead_cache_tail():
    B, H, KH, S, D = 1, 4, 2, 128, 32
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, H, KH, S, D, 3))
    live = 40
    k_dirty, v_dirty = k.clone(), v.clone()
    k_dirty[:, :, live:] = 1e6
    v_dirty[:, :, live:] = -1e6
    lengths = torch.tensor([live], dtype=torch.int32)
    clean = ops.decode_attention(q, k, v, lengths, bk=64)
    dirty = ops.decode_attention(q, k_dirty, v_dirty, lengths, bk=64)
    np.testing.assert_allclose(clean.numpy(), dirty.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lengths", [[0, 0], [0, 37], [64, 128]])
def test_lengths_zero_inside_and_at_the_end_match_the_reference_kernel(lengths):
    B, H, KH, S, D = 2, 8, 2, 128, 64
    q, k, v = _qkv(B, H, KH, S, D, sum(lengths))
    ln = np.asarray(lengths, np.int32)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(ln), bk=64).numpy()
    want = np.asarray(ref_ops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               jnp.asarray(ln), bk=64))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert np.isfinite(got).all()
    for b, n in enumerate(lengths):
        if n == 0:
            np.testing.assert_array_equal(got[b], 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_token_major_cache_view_gives_the_same_result(dtype):
    """The static cache's (B, S, KH, D) layout, viewed as (B, KH, S, D)
    without a copy, against the reference on the transposed copy."""
    B, KH, G, S, D = 4, 2, 8, 96, 128
    rng = np.random.default_rng(11)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    q = jnp.asarray(rng.standard_normal((B, KH * G, D)), jdt)
    k_tok = jnp.asarray(rng.standard_normal((B, S, KH, D)), jdt)
    v_tok = jnp.asarray(rng.standard_normal((B, S, KH, D)), jdt)
    lengths = np.asarray([0, 1, 50, 96], np.int32)
    tk = convert.tensor_from_numpy(np.asarray(k_tok), "cpu")
    tv = convert.tensor_from_numpy(np.asarray(v_tok), "cpu")
    kv_view = (tk.transpose(1, 2), tv.transpose(1, 2))
    assert not kv_view[0].is_contiguous() and kv_view[0].stride(3) == 1
    got = ops.decode_attention(convert.tensor_from_numpy(np.asarray(q), "cpu"), *kv_view,
                               torch.from_numpy(lengths))
    want = ref_ops.decode_attention(q, k_tok.transpose(0, 2, 1, 3), v_tok.transpose(0, 2, 1, 3),
                                    jnp.asarray(lengths))
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    tol = 2e-3 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_plain_version_is_the_masked_softmax():
    B, KH, G, S, D = 2, 1, 2, 10, 16
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((B, KH, G, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, KH, S, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, KH, S, D)).astype(np.float32))
    lengths = torch.tensor([3, 10])
    got = ref.decode_attention(q, k, v, lengths)
    for b in range(B):
        n = int(lengths[b])
        p = torch.softmax(q[b] @ k[b, :, :n].transpose(-1, -2) * D ** -0.5, dim=-1)
        torch.testing.assert_close(got[b], p @ v[b, :, :n], rtol=1e-5, atol=1e-6)


def test_non_cpu_tensors_go_to_the_kernel_which_wants_cuda():
    q = torch.ones((1, 4, 64), device="meta")
    kv = torch.ones((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        ops.decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="bk"):
        ops.decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32), bk=0)
    assert kernel.HEAD_DIMS == (32, 64, 128) and kernel.MAX_GROUP == 16


@pytest.mark.parametrize("S,bkh,sms,want", [
    (6144, 8, 132, 33),  # the serving shape: about two blocks a SM
    (2048, 10, 132, 27),
    (100, 5, 132, 4),  # a short cache: one split per 32 positions
    (0, 8, 132, 1),
    (1 << 20, 1, 132, kernel.MAX_SPLITS),
])
def test_split_count_comes_from_shapes_alone(S, bkh, sms, want):
    assert kernel.num_splits(S, bkh, sms) == want


def test_splits_cover_each_live_key_once():
    """Split i of a sequence of length n takes keys [n*i/ns, n*(i+1)/ns):
    together they are 0..n-1 in order, and none is empty once n >= ns."""
    for ns in (1, 2, 3, 7, 33, kernel.MAX_SPLITS):
        for n in (0, 1, ns - 1, ns, ns + 1, 1000):
            bounds = [(n * i // ns, n * (i + 1) // ns) for i in range(ns)]
            assert [t for lo, hi in bounds for t in range(lo, hi)] == list(range(n))
            if n >= ns:
                assert all(hi > lo for lo, hi in bounds)


def test_ticket_buffer_is_zeroed_once_and_grows():
    dev = torch.device("cpu")  # the buffer logic is the same on every device
    first = kernel.tickets(dev, 3)
    assert first.numel() >= kernel.TICKETS0 and first.dtype == torch.int32
    assert not first.any() and kernel.tickets(dev, kernel.TICKETS0) is first
    grown = kernel.tickets(dev, first.numel() + 1)
    assert grown.numel() > first.numel() and not grown.any()
    assert kernel.tickets(dev, 1) is grown and any(t is first for t in kernel._retired)


def test_ticket_buffer_is_not_made_inside_a_graph_capture(monkeypatch):
    """Inside a CUDA-graph capture the zero fill would only be recorded, so
    making or growing the buffer there raises before anything is allocated."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    dev = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="before a CUDA-graph capture"):
        kernel.tickets(dev, 8)
    assert dev not in kernel._tickets
