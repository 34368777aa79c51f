"""Mixture-of-Experts with parallel-insertion dispatch — port of
``repro/models/moe.py``.

Giving each routed token a unique slot in its expert's buffer is the
paper's insertion problem: experts are the LFVector blocks, token
assignments the insertion mask, and a token's rank in its expert is the
exclusive prefix sum over the (experts, tokens·k) assignment matrix,
computed by ``core.insertion.insertion_offsets`` under
``cfg.insertion_method`` (``tile`` is K1, ``mxu`` K2 on a card).

Two execution paths, chosen as the reference chooses them:

``_moe_local``   — one global (E·C, D) buffer: no mesh, or sizes that do
    not divide over it (decode's S = 1).  On ``DTensor`` activations every
    rank routes all tokens in a ``local_map`` region and the expert FFN runs
    on the expert-sharded weights (``_moe_local_mesh``).
``_moe_sharded`` — under a mesh with a ``'model'`` axis: each shard routes
    its own (B/dp, S/tp) tokens and runs the insertion scan shard-locally
    (one LFVector set a shard, capacity ``expert_capacity(moe, T_local)``,
    so a shard drops at its own boundary), builds a local (E, C_local, D)
    buffer and exchanges expert rows with one ``all_to_all`` over the
    ``'model'`` group, there and back.  On ``DTensor`` inputs the local
    block is a ``local_map`` region, PyTorch's ``shard_map``; the kernels
    see local tensors only.

The router, the softmax, the expert FFN and the combine are plain
PyTorch, as the reference leaves them to XLA.

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
from repro_torch.distributed.context import active_mesh, is_dtensor, mesh_axes, placements, reduce_partial
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
    """SwiGLU per expert: (E, C, D) → (E, C, D), one batched product each.
    On a mesh (``_moe_local_mesh``) the gate's and up's pending sums over a
    sharded D are reduced before the activation (``reduce_partial``): left
    to the activation's rule, torch versions reduce them differently (2.13
    reduce-scatters, 2.11 all-reduces)."""
    h = F.silu(reduce_partial(torch.bmm(buf, p["w_gate"]))) * reduce_partial(torch.bmm(buf, p["w_up"]))
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


def _moe_local(p: Param, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """One global buffer — one device, and shapes that do not divide over a mesh."""
    if is_dtensor(x):
        return _moe_local_mesh(p, x, cfg)
    moe = cfg.moe
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    C = expert_capacity(moe, T)
    buf, slot, gate, (density, router_prob) = _route_and_pack(p, xt, cfg, C)
    out = _combine(_expert_ffn(p, buf), slot, gate, T)
    aux = moe.n_experts * torch.sum(density * router_prob) * moe.top_k
    return out.reshape(B, S, D), aux


def _moe_local_mesh(p: Param, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """``_moe_local`` on ``DTensor`` activations (decode: S = 1 does not
    divide over ``'model'``).  Every rank routes and packs all B·S tokens in
    a ``local_map`` region, so the capacity and the drops are the global
    ones the reference's ``_moe_local`` gets under GSPMD; the expert FFN runs
    as ``DTensor`` products on the expert-sharded weights; the combine is a
    region again, on the gathered expert rows."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.context import local_region

    moe = cfg.moe
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    B, S, D = x.shape
    T = B * S
    C = expert_capacity(moe, T)

    def route_block(xl, router):
        buf, slot, gate, (density, router_prob) = _route_and_pack({"router": router}, xl.reshape(T, D),
                                                                  cfg, C)
        return buf, slot, gate, density, router_prob

    buf, slot, gate, density, router_prob = local_region(route_block, mesh, (rep, rep), (rep,) * 5)(
        x, p["router"])
    out = _expert_ffn(p, buf)
    y = local_region(lambda ob, sl, g: _combine(ob, sl, g, T).reshape(B, S, D), mesh, (rep, rep, rep),
                     rep)(out, slot, gate)
    return y, moe.n_experts * torch.sum(density * router_prob) * moe.top_k


class _MeshMean(torch.autograd.Function):
    """The reference's ``pmean`` of a result every rank then holds: the sum
    over ``groups`` (one a mesh dim) over the rank count.  Its cotangent
    arrives replicated, so each rank's share is it over the count, with no
    exchange (what ``shard_map`` gives an unmapped output)."""

    @staticmethod
    def forward(ctx, x, groups, n):
        import torch.distributed as dist

        ctx.n = n
        y = x.clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` in equal parts over ``group``: part j of dim 0
    to rank j, the received parts in rank order.  PyTorch's differentiable
    form: its backward sends the cotangent back the same way."""
    from torch.distributed._functional_collectives import all_to_all_single_autograd

    return all_to_all_single_autograd(t.contiguous(), None, None, group)


def _exchange(t: torch.Tensor, group, tp: int, to_owner: bool) -> torch.Tensor:
    """The reference's tiled ``all_to_all`` over the ``'model'`` group.
    ``to_owner``: (E, C, D) → (E/tp, tp·C, D), expert rows to their owner
    and the peers' rows concatenated in rank order along axis 1; else the
    inverse, (E/tp, tp·C, D) → (E, C, D)."""
    if to_owner:  # split axis 0, concat axis 1
        E, C, D = t.shape
        got = _all_to_all(t, group)
        return got.reshape(tp, E // tp, C, D).permute(1, 0, 2, 3).reshape(E // tp, tp * C, D)
    El, TC, D = t.shape  # split axis 1, concat axis 0
    send = t.reshape(El, tp, TC // tp, D).permute(1, 0, 2, 3)
    return _all_to_all(send, group).reshape(tp * El, TC // tp, D)


def _moe_sharded(p: Param, x: torch.Tensor, cfg: ModelConfig, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Local routing and insertion on each shard, ``all_to_all`` over the
    expert axis.  ``x`` a ``DTensor`` on ``mesh`` (the local block runs under
    ``local_map``), or a plain tensor on a one-rank mesh (the same block,
    groups of one)."""
    from torch.distributed.tensor import Partial, Replicate

    moe = cfg.moe
    B, S, D = x.shape
    sizes = mesh_axes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    tp = sizes["model"]
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    T_local = (B // dp_size) * (S // tp)
    C_local = expert_capacity(moe, T_local)
    names = list(sizes)
    model_group = mesh.get_group("model")
    groups = [mesh.get_group(a) for a in names]  # aux: the mean over every mesh axis
    n = mesh.size()

    def local_block(xl, router, w_gate, w_up, w_down):
        # xl: (B/dp, S/tp, D) — this shard's tokens (one LFVector set a shard)
        b, s, _ = xl.shape
        pl = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
        xt = xl.reshape(b * s, D)
        buf, slot, gate, (density, router_prob) = _route_and_pack(pl, xt, cfg, C_local)
        # EP exchange: expert rows to their owners, this shard's experts
        # gathered from every peer → (E/tp, tp·C_local, D), and back
        out = _exchange(_expert_ffn(pl, _exchange(buf, model_group, tp, True)), model_group, tp,
                        False)
        y = _combine(out, slot, gate, b * s)
        aux = moe.n_experts * moe.top_k * _MeshMean.apply(torch.sum(density * router_prob), groups, n)
        return y.reshape(b, s, D), aux

    args = (x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    if not is_dtensor(x):
        if mesh.size() == 1:
            return local_block(*args)
        # plain activations every rank holds alike: the same block on them
        # as replicated DTensors, the result handed back plain
        from repro_torch.distributed.context import as_dtensor

        rep = [Replicate()] * mesh.ndim
        y, aux = _moe_sharded(p, as_dtensor(x, mesh), cfg, mesh)
        return y.redistribute(mesh, rep).to_local(), aux.redistribute(mesh, rep).to_local()
    from repro_torch.distributed.context import local_region

    xplace = placements((dp or None, "model", None), mesh)
    wplace = placements(("model", None, None), mesh)
    rep = [Replicate()] * len(names)
    # a replicated input's gradient is each shard's partial sum, as the
    # reference's shard_map transposes an unmapped input
    wgrad = [p_ if p_.is_shard() else Partial() for p_ in wplace]
    run = local_region(local_block, mesh, (xplace, rep, wplace, wplace, wplace), (xplace, rep),
                       (xplace, [Partial()] * len(names), wgrad, wgrad, wgrad))
    return run(*args)


def moe_block(p: Param, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert MLP. x: (B, S, D) → (out, aux_loss f32 scalar).
    ``_moe_sharded`` whenever a mesh with a ``'model'`` axis is active and
    the sizes divide over it, as the reference chooses."""
    mesh = active_mesh()
    B, S, _ = x.shape
    if mesh is not None:
        sizes = mesh_axes(mesh)
        if "model" in sizes:
            tp = sizes["model"]
            dp = 1
            for a in ("pod", "data"):
                dp *= sizes.get(a, 1)
            if S % tp == 0 and cfg.moe.n_experts % tp == 0 and B % dp == 0:
                return _moe_sharded(p, x, cfg, mesh)
    return _moe_local(p, x, cfg)
