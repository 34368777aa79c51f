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
from repro_torch.distributed.context import (constrain, is_dtensor, local_region, logical_spec, merge_ready,
                                             merge_ready_grad, mesh_axes, rank_index)
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
    qr = _group_heads(q, KH, group)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.to(_F32)) * (Dh ** -0.5)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(mask[None, None, None], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(_F32))
    return _pinned_reshape(out, (B, Sq, H, Dh)).to(q.dtype)


def _state0(qr: torch.Tensor) -> SoftmaxState:
    """The empty online-softmax state of grouped queries ``qr`` (B, Sq, KH,
    G, Dh) f32, laid out as ``qr`` is (on a mesh, each rank its shard)."""
    lead = qr[..., 0]
    return SoftmaxState(
        m=torch.full_like(lead, MASK_VALUE),
        l=torch.zeros_like(lead),
        acc=torch.zeros_like(qr),
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


def _head_ranks(q: torch.Tensor) -> int:
    """The ranks that split the heads dim of a ``DTensor`` (B, S, H, Dh)."""
    n = 1
    for d, p in enumerate(q.placements):
        if p.is_shard(2):
            n *= q.device_mesh.size(d)
    return n


def _group_heads(q: torch.Tensor, kh: int, group: int) -> torch.Tensor:
    """(B, S, H, Dh) → (B, S, KH, G, Dh) f32.  On a mesh whose ``'model'``
    axis shards the heads but not the KH kv heads, DTensor cannot split the
    heads dim: the heads first move off ``'model'`` onto the sequence, the
    layout the blockwise walk wants next anyway."""
    if is_dtensor(q) and kh % _head_ranks(q):
        q = constrain(q, ("batch", "seq", None, None))
    B, Sq, _, Dh = q.shape
    return q.reshape(B, Sq, kh, group, Dh).to(_F32)


class _PinnedReshape(torch.autograd.Function):
    """``x.reshape(shape)`` of a ``DTensor`` whose backward lays the
    gradient out as the output was laid out before reshaping it back.  A
    gradient arriving in another layout may not reshape cleanly: heads
    sharded over ``'model'`` cannot be split into (KH, G) again
    (``_group_heads``), and KV chunks sharded within make a strided shard
    of the sequence that a later redistribution cannot undo on fake
    tensors."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = x.shape
        out = x.reshape(shape)
        ctx.placements = tuple(out.placements)
        return out

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g.reshape(ctx.in_shape), None


def _pinned_reshape(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``x.reshape(shape)``; on a ``DTensor``, ``_PinnedReshape``."""
    return _PinnedReshape.apply(x, shape) if is_dtensor(x) else x.reshape(shape)


def _blockwise_attention(q, k, v, *, group, causal, chunk, q_offset=0):
    """Flash attention in plain PyTorch: loop over KV chunks, carry softmax state."""
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    chunk = min(chunk, Skv)
    pad = (-Skv) % chunk
    k, v = _pad_seq(k, pad), _pad_seq(v, pad)
    n_chunks = k.shape[1] // chunk
    qr = _group_heads(q, KH, group) * (Dh ** -0.5)
    # q stays seq-sharded; each KV chunk is small and streamed per step
    qr = constrain(qr, ("batch", "seq", None, None, None))
    kc = constrain(_pinned_reshape(k, (B, n_chunks, chunk, KH, Dh)).movedim(1, 0),
                   (None, "batch", None, None, None))
    vc = constrain(_pinned_reshape(v, (B, n_chunks, chunk, KH, Dh)).movedim(1, 0),
                   (None, "batch", None, None, None))
    dev = q.device
    qpos = q_offset + torch.arange(Sq, device=dev)
    state = _state0(qr)
    for ci in range(n_chunks):
        kpos = ci * chunk + torch.arange(chunk, device=dev)
        live = kpos < Skv
        if causal:
            live = live[None, :] & (qpos[:, None] >= kpos[None, :])
            live = live[None, :, None, None, :]
        else:
            live = live[None, None, None, None, :]
        state = softmax_update(state, qr, kc[ci], vc[ci], live)
    out = state.acc / torch.clamp(state.l[..., None], min=1e-30)
    return _pinned_reshape(out, (B, Sq, H, Dh)).to(q.dtype)


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
    state = _state0(qr)
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


def _causal_tri_state(qr, k, v, chunk, q_offset=0, first=0, lo=0, hi=None):
    """Recursive triangular causal attention (flop-exact ~n(n+1)/2 chunks):
    causal([A;B]) = [causal(A); merge(causal(B), rect(B→A))].

    ``qr`` holds query rows ``first`` to ``first + rows`` of the node
    [lo, hi) of the recursion (the whole sequence by default); k and v hold
    the whole sequence.  The rows get the states the whole recursion gives
    them, in its arithmetic row for row, so a rank holding some of the rows
    computes them alone (``_tri_zigzag``)."""
    hi = k.shape[1] if hi is None else hi
    if hi - lo <= chunk:
        return _diag_state(qr, k[:, lo:hi], v[:, lo:hi], q_offset + first, q_offset + lo)
    mid = lo + (hi - lo) // 2
    if first + qr.shape[1] <= mid:
        return _causal_tri_state(qr, k, v, chunk, q_offset, first, lo, mid)
    if first >= mid:
        state = _causal_tri_state(qr, k, v, chunk, q_offset, first, mid, hi)
        return _merge_states(state, _rect_state(qr, k[:, lo:mid], v[:, lo:mid], chunk))
    a = mid - first
    state_a = _causal_tri_state(qr[:, :a], k, v, chunk, q_offset, first, lo, mid)
    state_b = _causal_tri_state(qr[:, a:], k, v, chunk, q_offset, mid, lo, hi)
    return SoftmaxState(*(torch.cat([x, y], dim=1) for x, y in zip(state_a, state_b)))


def _zigzag_ranks(q: torch.Tensor, kh: int) -> int:
    """How many ranks ``_group_heads`` will split q's sequence over (it
    moves the heads there when the kv heads do not divide over them); 1
    where it keeps the heads, or q is no ``DTensor``."""
    if not is_dtensor(q) or any(p.is_shard(1) for p in q.placements) or kh % _head_ranks(q) == 0:
        return 1
    mesh = q.device_mesh
    axis = logical_spec(tuple(q.shape), ("batch", "seq", None, None), mesh)[1]
    sizes = mesh_axes(mesh)
    n = 1
    for a in (() if axis is None else axis if isinstance(axis, tuple) else (axis,)):
        n *= sizes[a]
    return n


def _tri_zigzag(q, k, v, *, group, chunk, q_offset, n):
    """Triangular causal attention on a mesh that splits the sequence over
    ``n`` ranks, each rank computing its own query rows alone in a
    ``local_map`` region against the whole k and v.  Slicing the
    sequence-sharded queries as the recursion halves them would gather
    them on every rank (DTensor replicates a sliced sharded dim): every
    rank would compute every query's scores.  The rows are dealt out as
    2n half-blocks, rank r holding half-blocks r and 2n − 1 − r, so that
    each rank's rows reach back over as many keys (the causal triangle's
    work, balanced): the sequence is permuted while the heads still shard
    q (no exchange), the heads then move to the sequence as
    ``_group_heads`` moves them, and the output moves back onto the heads
    (the layout ``project_out`` wants) before the inverse permutation."""
    from torch.distributed.tensor import Partial, Replicate

    B, Sq, H, Dh = q.shape
    KH = k.shape[2]
    half = Sq // (2 * n)
    order = [b for r in range(n) for b in (r, 2 * n - 1 - r)]
    perm = torch.cat([torch.arange(b * half, (b + 1) * half, device=q.device) for b in order])
    qr = _group_heads(_permute_seq(q, perm), KH, group) * (Dh ** -0.5)
    mesh = qr.device_mesh
    place = list(qr.placements)
    seq_dims = [d for d, p in enumerate(place) if p.is_shard(1)]
    kv = [p if p.is_shard(0) else Replicate() for p in place]
    kv_grad = [p if p.is_shard(0) else Partial() if p.is_shard(1) else Replicate() for p in place]
    r = rank_index(mesh, seq_dims)
    firsts = (r * half, (2 * n - 1 - r) * half)

    def block(qr_, k_, v_):
        states = [_causal_tri_state(qr_[:, i * half:(i + 1) * half], k_, v_, chunk, q_offset, first)
                  for i, first in enumerate(firsts)]
        state = SoftmaxState(*(torch.cat(parts, dim=1) for parts in zip(*states)))
        return state.acc / torch.clamp(state.l[..., None], min=1e-30)

    out = local_region(block, mesh, (place, kv, kv), place, (place, kv_grad, kv_grad))(qr, k, v)
    out = constrain(_pinned_reshape(out, (B, Sq, H, Dh)).to(q.dtype), ("batch", None, "heads", None))
    return _permute_seq(out, torch.argsort(perm))


def _permute_seq(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x.index_select(1, perm)`` of a ``DTensor`` whose sequence (dim 1)
    no mesh dim splits, on each rank's local tensor (a ``local_map``
    region): DTensor has no rule for the gradient's ``index_add`` under
    some torch versions (2.11)."""
    place = list(x.placements)
    return local_region(lambda t: t.index_select(1, perm), x.device_mesh, (place,), place)(x)


def _blockwise_tri_attention(q, k, v, *, group, causal, chunk, q_offset=0):
    B, Sq, H, Dh = q.shape
    KH = k.shape[2]
    if causal and Sq == k.shape[1]:
        n = _zigzag_ranks(q, KH)
        if n > 1 and Sq % (2 * n) == 0:
            return _tri_zigzag(q, k, v, group=group, chunk=chunk, q_offset=q_offset, n=n)
    qr = _group_heads(q, KH, group) * (Dh ** -0.5)
    if not causal or Sq != k.shape[1]:
        state = _rect_state(qr, k, v, chunk)
    else:
        state = _causal_tri_state(qr, k, v, chunk, q_offset)
    out = state.acc / torch.clamp(state.l[..., None], min=1e-30)
    return _pinned_reshape(out, (B, Sq, H, Dh)).to(q.dtype)


def _pallas_attention(q, k, v, *, group, causal):
    """K13 on (B, S, H, Dh) tensors.

    The reference transposes into (B·H, S, Dh) copies for its kernel; the
    port hands the kernel strided (B, H, S, Dh) views and lets it write the
    (B, S, H, Dh) output in place, so no transpose is copied on the card.

    K13 has no backward, as the reference's Pallas kernel has none (its
    ``train_step`` under ``attention_impl="pallas"`` fails to
    differentiate): under grad mode with q, k or v requiring grad this
    raises, on the CPU and on the card alike, rather than return an output
    that no gradient flows through.
    """
    from repro_torch.kernels.flash_attention import ops as fa_ops

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "attention_impl='pallas' (K13) has no backward: train with "
            "'blockwise', 'blockwise_tri' or 'xla', or call under torch.no_grad()"
        )

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


def _split_head_dim(w: torch.Tensor, h_dim: int) -> bool:
    """True for a ``DTensor`` weight whose head_dim (dim ``h_dim + 1``) a
    mesh dim shards under more than one head (dim ``h_dim``): flattening
    (heads, head_dim) then mixes a whole dim with a sharded one, which
    DTensor cannot unflatten again (the heads did not divide over
    ``'model'``, ``sharding.logical_rules``)."""
    return (is_dtensor(w) and w.shape[h_dim] > 1
            and any(p.is_shard(h_dim + 1) for p in w.placements))


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads; over
    the (head_dim, heads)-ordered ones where the heads' head_dim is sharded
    (``_split_head_dim``: only the first merged dim may be sharded, as
    ``merge_ready`` keeps it), laid back out as (heads, head_dim).  On a
    mesh the sequence is gathered first (``merge_ready``: Megatron's
    sequence-parallel gather), the output sharded as the weight's heads."""
    d, h, k = w.shape
    x = merge_ready(x)
    if _split_head_dim(w, 1):
        y = x @ w.transpose(1, 2).reshape(d, k * h)
        return y.reshape(*x.shape[:-1], k, h).transpose(-1, -2)
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def project_qkv(p: Param, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """x: (B, S, D) → q (B,S,H,Dh), k,v (B,S,KH,Dh) with bias/qk-norm/rope.
    Head-sharded on a mesh (Megatron TP)."""
    q = constrain(project_heads(x, p["wq"]), ("batch", None, "heads", None))
    k = constrain(project_heads(x, p["wk"]), ("batch", None, "kv_heads", None))
    v = constrain(project_heads(x, p["wv"]), ("batch", None, "kv_heads", None))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def project_out(p: Param, attn_out: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul over the flattened heads; over
    the (head_dim, heads)-ordered ones where the heads' head_dim is sharded
    (as ``project_heads``).  On a mesh a sequence-sharded ``attn_out``
    moves onto the heads first (the weight's layout: an all-to-all, not a
    gather); the output is the heads' partial sums, which the residual add
    reduce-scatters onto the sequence (``steps.decode_step`` reduces them
    before its adds)."""
    h, k, d = p["wo"].shape
    if is_dtensor(attn_out) and any(getattr(q, "dim", None) == 1 for q in attn_out.placements):
        attn_out = constrain(attn_out, ("batch", None, "heads", None))
    attn_out = merge_ready(attn_out, 0, attn_out.ndim - 2)
    if _split_head_dim(p["wo"], 0):
        flat = attn_out.transpose(-1, -2).reshape(*attn_out.shape[:-2], k * h)
        return merge_ready_grad(flat @ p["wo"].transpose(0, 1).reshape(k * h, d))
    return merge_ready_grad(attn_out.reshape(*attn_out.shape[:-2], h * k) @ p["wo"].reshape(h * k, d))


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
