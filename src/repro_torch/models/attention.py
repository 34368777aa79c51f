"""Attention: GQA projections + four interchangeable inner implementations —
port of ``repro/models/attention.py``.

``blockwise``      — flash attention in plain PyTorch: online softmax over KV
                     chunks (a Python loop where the reference scans).
``blockwise_tri``  — the recursive triangular causal split (flop-exact).
``xla``            — naive softmax (tiny shapes / oracle).
``pallas``         — K13, the hand-written CUDA flash kernel
                     (``kernels/flash_attention``) on a card, its plain
                     version on the CPU.

The arithmetic of each impl is the reference's, step for step (the same
einsums, masks with ``MASK_VALUE``, max/exp/accumulate order), so the two
packages agree within float rounding.  Tensors are ``(B, S, H, Dh)`` as in the
reference.  The decode path (one query against a cache) lives in
``serving/kvcache.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.modules import Param, apply_rope, dense_init, rms_norm, rope

__all__ = [
    "init_attention",
    "attention_block",
    "project_qkv",
    "project_heads",
    "project_out",
    "inner_attention",
    "SoftmaxState",
    "softmax_update",
    "MASK_VALUE",
]

MASK_VALUE = -1e30
_F32 = torch.float32


class SoftmaxState(NamedTuple):
    m: torch.Tensor  # running max per query row
    l: torch.Tensor  # running denominator per query row
    acc: torch.Tensor  # (..., d) running numerator


# --------------------------------------------------------------------------
# Inner attention implementations. q: (B, Sq, H, Dh); k,v: (B, Skv, KH, Dh).
# --------------------------------------------------------------------------

def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad, *x.shape[2:]))], dim=1)


def _xla_attention(q, k, v, *, group, causal, q_offset=0):
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    qr = q.reshape(B, Sq, KH, group, Dh).to(_F32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.to(_F32)) * (Dh ** -0.5)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(mask[None, None, None], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(_F32))
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _state0(B, Sq, KH, G, Dh, device) -> SoftmaxState:
    return SoftmaxState(
        m=torch.full((B, Sq, KH, G), MASK_VALUE, dtype=_F32, device=device),
        l=torch.zeros((B, Sq, KH, G), dtype=_F32, device=device),
        acc=torch.zeros((B, Sq, KH, G, Dh), dtype=_F32, device=device),
    )


def softmax_update(state: SoftmaxState, qr, kk, vv, live) -> SoftmaxState:
    """One online-softmax step — the reference's blockwise scan body, which
    its chunked prefill (``kvcache.chunk_attend``) repeats verbatim."""
    s = torch.einsum("bqkgd,bckd->bqkgc", qr, kk.to(_F32))
    s = torch.where(live, s, MASK_VALUE)
    m_new = torch.maximum(state.m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(state.m - m_new)
    l = state.l * alpha + torch.sum(p, dim=-1)
    pv = torch.einsum("bqkgc,bckd->bqkgd", p, vv.to(_F32))
    return SoftmaxState(m_new, l, state.acc * alpha[..., None] + pv)


def _blockwise_attention(q, k, v, *, group, causal, chunk, q_offset=0):
    """Flash attention in plain PyTorch: loop over KV chunks, carry softmax state."""
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    chunk = min(chunk, Skv)
    pad = (-Skv) % chunk
    k, v = _pad_seq(k, pad), _pad_seq(v, pad)
    n_chunks = k.shape[1] // chunk
    qr = q.reshape(B, Sq, KH, group, Dh).to(_F32) * (Dh ** -0.5)
    dev = q.device
    qpos = q_offset + torch.arange(Sq, device=dev)
    state = _state0(B, Sq, KH, group, Dh, dev)
    for ci in range(n_chunks):
        kpos = ci * chunk + torch.arange(chunk, device=dev)
        live = kpos < Skv
        if causal:
            live = live[None, :] & (qpos[:, None] >= kpos[None, :])
            live = live[None, :, None, None, :]
        else:
            live = live[None, None, None, None, :]
        state = softmax_update(state, qr, k[:, ci * chunk:(ci + 1) * chunk],
                        v[:, ci * chunk:(ci + 1) * chunk], live)
    out = state.acc / torch.clamp(state.l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _merge_states(a: SoftmaxState, b: SoftmaxState) -> SoftmaxState:
    """Combine two online-softmax partials over disjoint KV sets."""
    m = torch.maximum(a.m, b.m)
    ea, eb = torch.exp(a.m - m), torch.exp(b.m - m)
    return SoftmaxState(m=m, l=a.l * ea + b.l * eb,
                        acc=a.acc * ea[..., None] + b.acc * eb[..., None])


def _rect_state(qr, k, v, chunk):
    """Unmasked blockwise attention returning the softmax state.

    qr: (B, Sq, KH, G, Dh) pre-scaled f32; k/v: (B, Skv, KH, Dh).
    """
    B, Sq, KH, G, Dh = qr.shape
    Skv = k.shape[1]
    chunk = min(chunk, Skv)
    pad = (-Skv) % chunk
    k, v = _pad_seq(k, pad), _pad_seq(v, pad)
    dev = qr.device
    state = _state0(B, Sq, KH, G, Dh, dev)
    for ci in range(k.shape[1] // chunk):
        live = (ci * chunk + torch.arange(chunk, device=dev)) < Skv
        state = softmax_update(state, qr, k[:, ci * chunk:(ci + 1) * chunk],
                        v[:, ci * chunk:(ci + 1) * chunk], live[None, None, None, None, :])
    return state


def _diag_state(qr, k, v, q_offset, kv_offset):
    """One causal leaf block: masked single-chunk attention state."""
    dev = qr.device
    s = torch.einsum("bqkgd,bckd->bqkgc", qr, k.to(_F32))
    qpos = q_offset + torch.arange(qr.shape[1], device=dev)
    kpos = kv_offset + torch.arange(k.shape[1], device=dev)
    mask = qpos[:, None] >= kpos[None, :]
    s = torch.where(mask[None, :, None, None, :], s, MASK_VALUE)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bqkgc,bckd->bqkgd", p, v.to(_F32))
    return SoftmaxState(m, l, acc)


def _causal_tri_state(qr, k, v, chunk, q_offset=0):
    """Recursive triangular causal attention (flop-exact ~n(n+1)/2 chunks):
    causal([A;B]) = [causal(A); merge(causal(B), rect(B→A))]."""
    S = qr.shape[1]
    if S <= chunk:
        return _diag_state(qr, k, v, q_offset, q_offset)
    half = S // 2
    state_a = _causal_tri_state(qr[:, :half], k[:, :half], v[:, :half], chunk, q_offset)
    state_b = _causal_tri_state(qr[:, half:], k[:, half:], v[:, half:], chunk, q_offset + half)
    state_b = _merge_states(state_b, _rect_state(qr[:, half:], k[:, :half], v[:, :half], chunk))
    return SoftmaxState(*(torch.cat([a, b], dim=1) for a, b in zip(state_a, state_b)))


def _blockwise_tri_attention(q, k, v, *, group, causal, chunk, q_offset=0):
    B, Sq, H, Dh = q.shape
    KH = k.shape[2]
    qr = q.reshape(B, Sq, KH, group, Dh).to(_F32) * (Dh ** -0.5)
    if not causal or Sq != k.shape[1]:
        state = _rect_state(qr, k, v, chunk)
    else:
        state = _causal_tri_state(qr, k, v, chunk, q_offset)
    out = state.acc / torch.clamp(state.l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _pallas_attention(q, k, v, *, group, causal):
    """K13 on (B, S, H, Dh) tensors.

    The reference transposes into (B·H, S, Dh) copies for its kernel; the
    port hands the kernel strided (B, H, S, Dh) views and lets it write the
    (B, S, H, Dh) output in place, so no transpose is copied on the card.
    """
    from repro_torch.kernels.flash_attention import ops as fa_ops

    out = torch.empty_like(q)
    fa_ops.flash_attention_bhsd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), out.transpose(1, 2),
        group=group, causal=causal,
    )
    return out


def inner_attention(q, k, v, cfg: ModelConfig, *, causal=None, q_offset=0):
    causal = cfg.causal if causal is None else causal
    group = q.shape[2] // k.shape[2]
    if cfg.attention_impl == "xla":
        return _xla_attention(q, k, v, group=group, causal=causal, q_offset=q_offset)
    if cfg.attention_impl == "pallas":
        return _pallas_attention(q, k, v, group=group, causal=causal)
    if cfg.attention_impl == "blockwise_tri":
        return _blockwise_tri_attention(
            q, k, v, group=group, causal=causal, chunk=cfg.attention_chunk, q_offset=q_offset
        )
    return _blockwise_attention(
        q, k, v, group=group, causal=causal, chunk=cfg.attention_chunk, q_offset=q_offset
    )


# --------------------------------------------------------------------------
# Full attention block: projections (+bias), qk-norm, rope.
# --------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, *,
                   lead: tuple[int, ...] = ()) -> Param:
    """``lead``: leading stacking dims (the period axis of a layer stack)."""
    d, dh = cfg.d_model, cfg.head_dim
    dev = gen.device
    p: Param = {
        "wq": dense_init(gen, (d, cfg.n_heads, dh), dtype, d, lead=lead),
        "wk": dense_init(gen, (d, cfg.n_kv_heads, dh), dtype, d, lead=lead),
        "wv": dense_init(gen, (d, cfg.n_kv_heads, dh), dtype, d, lead=lead),
        "wo": dense_init(gen, (cfg.n_heads, dh, d), dtype, cfg.n_heads * dh, lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, cfg.n_heads, dh), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((*lead, cfg.n_kv_heads, dh), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((*lead, cfg.n_kv_heads, dh), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, dh), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((*lead, dh), dtype=dtype, device=dev)
    return p


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def project_qkv(p: Param, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """x: (B, S, D) → q (B,S,H,Dh), k,v (B,S,KH,Dh) with bias/qk-norm/rope."""
    q, k, v = project_heads(x, p["wq"]), project_heads(x, p["wk"]), project_heads(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def project_out(p: Param, attn_out: torch.Tensor) -> torch.Tensor:
    h, k, d = p["wo"].shape
    return attn_out.reshape(*attn_out.shape[:-2], h * k) @ p["wo"].reshape(h * k, d)


def attention_block(
    p: Param,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    causal: bool | None = None,
    kv: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Self-attention, or cross-attention (non-causal, no rope on q) when
    ``kv`` brings the projected encoder K/V."""
    if kv is None:
        q, k, v = project_qkv(p, x, cfg, positions)
    else:
        q = project_heads(x, p["wq"])
        if cfg.qkv_bias:
            q = q + p["bq"]
        k, v = kv
        causal = False
    return project_out(p, inner_attention(q, k, v, cfg, causal=causal))
