"""Mixture-of-Experts with parallel-insertion dispatch — port of
``repro/models/moe.py``.

Giving each routed token a unique slot in its expert's buffer is the
paper's insertion problem: experts are the LFVector blocks, token
assignments the insertion mask, and a token's rank in its expert is the
exclusive prefix sum over the (experts, tokens·k) assignment matrix,
computed by ``core.insertion.insertion_offsets`` under
``cfg.insertion_method`` (``tile`` is K1, ``mxu`` K2 on a card).

Only the reference's ``_moe_local`` is ported: one global (E·C, D)
buffer.  ``_moe_sharded`` (``shard_map`` and an ``all_to_all`` over the
expert axis) needs a mesh, and the reference takes ``_moe_local`` on one
device too.  The router, the softmax, the expert FFN and the combine are
plain PyTorch, as the reference leaves them to XLA.

Top-k is a stable descending sort: ``jax.lax.top_k``'s order (values
descending, the lower expert first on a tie), which ``torch.topk`` does not
promise on a card.  The gate order fixes the combine's sum order and the
expert order fixes the ranks, so both must be the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import indexing
from repro_torch.core.insertion import insertion_offsets
from repro_torch.kernels.common import put_drop_
from repro_torch.models.modules import Param, dense_init

__all__ = ["init_moe", "moe_block", "expert_capacity", "route", "top_k_gates", "pack"]


def expert_capacity(moe: MoEConfig, n_tokens: int) -> int:
    """Per-expert buffer slots for a batch of ``n_tokens`` routed tokens."""
    mean = n_tokens * moe.top_k / moe.n_experts
    if moe.ggarray_capacity:
        # GGArray geometry: the next bucket-chain level ≥ the mean load
        need = int(mean) + 1
        nb = indexing.min_buckets_for(moe.capacity_b0, need)
        return indexing.capacity(moe.capacity_b0, max(nb, 1))
    return max(int(mean * moe.capacity_factor), 1)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, *,
             lead: tuple[int, ...] = ()) -> Param:
    """The router stays f32 whatever ``dtype`` is, as in the reference.
    Expert weights are drawn one (period, expert) slice at a time."""
    moe = cfg.moe
    d, dff, E = cfg.d_model, moe.d_ff_expert, moe.n_experts
    return {
        "router": dense_init(gen, (d, E), torch.float32, lead=lead),
        "w_gate": dense_init(gen, (d, dff), dtype, d, lead=(*lead, E)),
        "w_up": dense_init(gen, (d, dff), dtype, d, lead=(*lead, E)),
        "w_down": dense_init(gen, (dff, d), dtype, dff, lead=(*lead, E)),
    }


def route(p: Param, xt: torch.Tensor, cfg: ModelConfig):
    """xt: (T, D) → (probs (T, E) f32, gate (T, k) f32, expert (T, k) int64):
    an f32 softmax over the router logits, top-k, gates renormalised."""
    probs = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)
    return (probs, *top_k_gates(probs, cfg.moe.top_k))


def top_k_gates(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """probs (T, E) → (gate (T, k), expert (T, k) int64): ``jax.lax.top_k``
    by a stable descending sort, then the gates renormalised to sum 1."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[:, :k], idx[:, :k]
    return gate / torch.clamp(torch.sum(gate, dim=-1, keepdim=True), min=1e-9), expert


def pack(xt: torch.Tensor, expert: torch.Tensor, cfg: ModelConfig, C: int):
    """The parallel insertion: ranks from ``insertion_offsets`` over the
    one-hot (E, T·k) assignment, ``rank < C`` kept, rows scattered into
    their slots (dropped lanes write nothing) → (buf (E·C, D), slot (T·k,)
    int64, −1 where dropped; offsets (E, T·k) int32; assign (E, T·k) bool)."""
    E = cfg.moe.n_experts
    flat_expert = expert.reshape(-1)  # (Tk,)
    assign = flat_expert[None, :] == torch.arange(E, device=xt.device)[:, None]  # (E, Tk)
    offsets, _ = insertion_offsets(assign, method=cfg.insertion_method)
    rank = torch.gather(offsets, 0, flat_expert[None, :])[0].to(torch.int64)
    keep = rank < C
    slot = torch.where(keep, flat_expert * C + rank, -1)
    T, D = xt.shape
    xrep = xt[:, None].expand(T, cfg.moe.top_k, D).reshape(-1, D)  # (Tk, D): each row k times
    buf = xt.new_zeros((E * C, D))
    put_drop_(buf, (slot,), keep, xrep)
    return buf, slot, offsets, assign


def _route_and_pack(p: Param, xt: torch.Tensor, cfg: ModelConfig, C: int):
    """xt: (T, D) → (buf (E, C, D), slot (T·k,), gate (T, k), (density,
    router_prob)) — the reference's function of the same name."""
    probs, gate, expert = route(p, xt, cfg)
    buf, slot, _, assign = pack(xt, expert, cfg, C)
    density = torch.mean(assign.to(torch.float32), dim=1)
    router_prob = torch.mean(probs, dim=0)
    return buf.reshape(cfg.moe.n_experts, C, xt.shape[1]), slot, gate, (density, router_prob)


def _expert_ffn(p: Param, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert: (E, C, D) → (E, C, D), one batched product each."""
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _combine(out_buf: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor, T: int) -> torch.Tensor:
    """Gather each token's k expert rows (0 where dropped), weight by the
    gates in the activations' dtype and sum over k → (T, D)."""
    D = out_buf.shape[-1]
    flat = out_buf.reshape(-1, D)
    valid = slot >= 0
    gathered = torch.where(valid[:, None], flat[torch.where(valid, slot, 0)], 0.0)
    k = slot.shape[0] // T
    return torch.sum(gathered.reshape(T, k, D) * gate[..., None].to(out_buf.dtype), dim=1)


def moe_block(p: Param, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert MLP. x: (B, S, D) → (out, aux_loss f32 scalar)."""
    moe = cfg.moe
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    C = expert_capacity(moe, T)
    buf, slot, gate, (density, router_prob) = _route_and_pack(p, xt, cfg, C)
    out = _combine(_expert_ffn(p, buf), slot, gate, T)
    aux = moe.n_experts * torch.sum(density * router_prob) * moe.top_k
    return out.reshape(B, S, D), aux
