"""Serving steps — port of ``repro/serving/steps.py``: prefill (context
encode → cache), chunked prefill into shared paged caches, and decode (one
token), over every layer kind of the reference.

Where the reference scans a period body and threads the caches through the
scan (donated, updated by dynamic-update-slice), the port loops over periods
and writes each period's cache views in place (``kvcache.period_view``).
An attention slot's cache is a KV cache (plus ``cross_k``/``cross_v``, the
encoder's projected memory, in an encoder–decoder); a Mamba slot's is its
recurrent state, ``conv`` (P, B, d_conv-1, ch) and ``ssd`` (P, B, nh, hd,
n) f32.  ``constrain`` sits where the reference's does: the identity on
plain tensors (one card), a redistribution on a mesh's ``DTensor``.

With ``cfg.instrument`` each step opens one ``obs.device.tape()`` (the
reference opens one per scan iteration; PyTorch traces nothing) and returns
the sum of the counter vectors the cache ops recorded as an extra output —
device data, no transfer.

Every step runs under ``torch.no_grad()``: parameters that require grad (a
``train.step.TrainState``'s) serve as they are, and no graph is built
across decode steps.

On a mesh (``DTensor`` parameters and tokens under ``activation_mesh``)
the reference's GSPMD placement is written out: ``prefill`` returns its
caches placed by ``sharding.cache_specs`` (levels sharded on their slots
over ``'model'``, batch over the data axes, Mamba's conv and SSD states on
channels and heads), ``init_decode_caches(mesh=...)`` places them the same
way, and the cache ops run in ``local_map`` regions (``kvcache``).  State
writes go through :func:`_copy_into`, which lays the new state out as the
cache holds it.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.distributed.context import (active_mesh, as_dtensor, constrain, is_dtensor, placed_zeros,
                                             reduce_partial)
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import inner_attention, project_heads, project_out, project_qkv
from repro_torch.models.mlp import mlp_block
from repro_torch.models.modules import embed, rms_norm, unembed
from repro_torch.models.moe import moe_block
from repro_torch.models.transformer import DTYPES, check_supported, layer_params
from repro_torch.obs import device as obs_device
from repro_torch.serving import kvcache
from repro_torch.tree import tree_map

__all__ = [
    "prefill",
    "prefill_chunk",
    "decode_step",
    "init_decode_caches",
    "logits_from_hidden",
]


def logits_from_hidden(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = constrain(unembed(x, table), ("batch", "vocab"))
    if cfg.padded_vocab != cfg.vocab_size:
        live = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(live, logits, -1e30)
    return logits


def _keep(y: torch.Tensor) -> torch.Tensor:
    return y


def _mlp_or_moe(sp, x, slot: int, cfg: ModelConfig, settle=_keep):
    """``settle``: applied to the block's output before the residual add
    (``reduce_partial`` in the decode step)."""
    h = rms_norm(x, sp["norm2"], cfg.norm_eps)
    if cfg.is_moe_layer(slot):
        out, _ = moe_block(sp["moe"], h, cfg)
        return x + settle(out)
    return x + settle(mlp_block(sp["mlp"], h, cfg.activation))


def _cross(sp, x, ck, cv, cfg: ModelConfig, attend, settle=_keep):
    """The cross-attention sub-block: q from the normed residual (no bias,
    no rope, as the reference's steps), ``attend(q, k, v)`` over the
    encoder's K/V."""
    hc = rms_norm(x, sp["cross_norm"], cfg.norm_eps)
    qc = project_heads(hc, sp["cross"]["wq"])
    return x + settle(project_out(sp["cross"], attend(qc, ck, cv)))


def _scope(cfg: ModelConfig):
    """One counter tape per step when ``cfg.instrument``, else nothing."""
    return obs_device.tape() if cfg.instrument else contextlib.nullcontext()


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a ``DTensor`` ``dst`` takes ``src`` laid out as
    ``dst`` is, each rank writing its own shard in place."""
    if is_dtensor(dst):
        src = as_dtensor(src, dst.device_mesh).redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)


def _placed(caches: list, cfg: ModelConfig, mesh, device) -> list:
    """Zero caches of the shapes and dtypes of ``caches`` (shape-only:
    built on ``meta``) as ``DTensor``s placed by ``cache_specs`` on
    ``mesh``, each rank allocating its own shards on ``device``."""
    from repro_torch.distributed.sharding import cache_specs

    return tree_map(lambda t, spec: placed_zeros(tuple(t.shape), t.dtype, device, mesh, spec),
                    caches, cache_specs(caches, cfg, mesh))


def _with_counters(cfg: ModelConfig, out: tuple, t, device) -> tuple:
    """Append the tape's total to a step's outputs when ``cfg.instrument``."""
    return (*out, t.total(device)) if cfg.instrument else out


@torch.no_grad()
def prefill(
    params: dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    capacity_hint: int | None = None,
    policy: str | None = None,
    prefix_embeds: torch.Tensor | None = None,
    memory: torch.Tensor | None = None,
    lengths: torch.Tensor | None = None,  # (B,) per-seq prompt lengths (right-pad)
) -> tuple[torch.Tensor, list]:
    """→ (last-position logits (B, V), caches list[slot], period-stacked) — and
    the step's counter vector when ``cfg.instrument`` (zeros: the monolithic
    prefill has no counted kernel, as in the reference).

    ``prefix_embeds`` (B, P, D) are prepended to the token embeddings and
    take the first P positions.  With ``memory`` (B, S_enc, D) every
    attention slot cross-attends to it and keeps its projected K/V as
    ``cross_k``/``cross_v`` for the decode steps."""
    check_supported(cfg)
    policy = cfg.cache_policy if policy is None else policy
    x = embed(params["embed"], tokens).to(DTYPES[cfg.dtype])
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    dev = x.device
    cap = capacity_hint if capacity_hint is not None else S
    positions = torch.arange(S, device=dev)[None, :]
    P = cfg.n_periods
    mesh = active_mesh() if is_dtensor(x) else None
    at = "meta" if mesh is not None else dev  # shapes only, placed below
    caches = []
    for kind in cfg.layout:
        if kind == "mamba":
            caches.append(ssm_mod.init_mamba_state(cfg, B, x.dtype, at, lead=(P,))._asdict())
            continue
        c = kvcache.init_cache(cfg, B, cap, policy, stack=P, device=at)
        if memory is not None:
            shape = (P, B, memory.shape[1], cfg.n_kv_heads, cfg.head_dim)
            c["cross_k"] = torch.zeros(shape, dtype=x.dtype, device=at)
            c["cross_v"] = torch.zeros(shape, dtype=x.dtype, device=at)
        caches.append(c)
    if mesh is not None:
        caches = _placed(caches, cfg, mesh, dev)
    with _scope(cfg) as t:
        for i in range(P):
            x = constrain(x, ("batch", "seq", None))
            for slot, kind in enumerate(cfg.layout):
                sp = layer_params(params["layers"][slot], i)
                c = kvcache.period_view(caches[slot], i)
                h = rms_norm(x, sp["norm1"], cfg.norm_eps)
                if kind == "mamba":
                    y, st = ssm_mod.mamba_block(sp["mamba"], h, cfg, return_state=True)
                    x = x + y
                    _copy_into(c["conv"], st.conv)
                    _copy_into(c["ssd"], st.ssd)
                    continue
                q, k, v = project_qkv(sp["attn"], h, cfg, positions)
                x = x + project_out(sp["attn"], inner_attention(q, k, v, cfg, causal=True))
                kvcache.fill_from_prefill({key: val for key, val in c.items()
                                           if not key.startswith("cross")}, k, v)
                if memory is not None:
                    ck = project_heads(memory, sp["cross"]["wk"])
                    cv = project_heads(memory, sp["cross"]["wv"])
                    x = _cross(sp, x, ck, cv, cfg,
                               lambda q_, k_, v_: inner_attention(q_, k_, v_, cfg, causal=False))
                    _copy_into(c["cross_k"], ck)
                    _copy_into(c["cross_v"], cv)
                x = _mlp_or_moe(sp, x, slot, cfg)
    if lengths is None:
        last = x[:, -1]
    else:
        idx = torch.as_tensor(lengths, device=dev).long() - 1
        last = x[torch.arange(B, device=dev), idx]
    return _with_counters(cfg, (logits_from_hidden(params, last, cfg), caches), t, dev)


@torch.no_grad()
def prefill_chunk(
    params: dict,
    tokens: torch.Tensor,  # (1, Cb) bucket-padded chunk of one prompt
    caches: list,  # the BatchEngine's shared caches, written in place
    slot: int,  # decode slot owning this prompt
    t0: int,  # prompt tokens already prefilled
    live: int,  # live tokens in this chunk (Cb − live are padding)
    pages_row: torch.Tensor,  # (maxp,) the slot's claimed slab ids, −1-padded
    cfg: ModelConfig,
    first: bool = True,  # t0 == 0: fresh state, no prefix to attend
) -> tuple[torch.Tensor, list]:
    """→ (last-live-position logits (1, V), caches) — and the summed counter
    vector when ``cfg.instrument``.  ``t0`` and ``live`` are the scheduler's
    host ints.

    Mamba slots run the resumable SSD block against ``slot``'s state row.
    The first chunk runs from a zero state on the monolithic chunk grid
    (``state=None``), whatever the row holds: a reused slot still has the
    previous tenant's final state."""
    check_supported(cfg)
    x = embed(params["embed"], tokens).to(DTYPES[cfg.dtype])
    Cb = tokens.shape[1]
    positions = (t0 + torch.arange(Cb, device=x.device))[None, :]
    with _scope(cfg) as t:
        for i in range(cfg.n_periods):
            x = constrain(x, ("batch", None, None))
            for lslot, kind in enumerate(cfg.layout):
                sp = layer_params(params["layers"][lslot], i)
                c = kvcache.period_view(caches[lslot], i)
                h = rms_norm(x, sp["norm1"], cfg.norm_eps)
                if kind == "mamba":
                    st = None if first else ssm_mod.MambaState(
                        conv=c["conv"][slot][None], ssd=c["ssd"][slot][None])
                    y, st = ssm_mod.mamba_block(sp["mamba"], h, cfg, state=st, return_state=True)
                    x = x + y
                    c["conv"][slot].copy_(st.conv[0])
                    c["ssd"][slot].copy_(st.ssd[0])
                    continue
                q, k, v = project_qkv(sp["attn"], h, cfg, positions)
                att = kvcache.chunk_attend(c, pages_row, q, k, v, t0, live, cfg, first=first)
                x = x + project_out(sp["attn"], att)
                kvcache.scatter_chunk(c, pages_row, k, v, t0, live, cfg)
                x = _mlp_or_moe(sp, x, lslot, cfg)
    out = (logits_from_hidden(params, x[0, live - 1][None], cfg), caches)
    return _with_counters(cfg, out, t, x.device)


def init_decode_caches(
    cfg: ModelConfig,
    batch: int,
    length_hint: int,
    *,
    policy: str | None = None,
    enc_len: int | None = None,
    device: "torch.device | str | None" = None,
    mesh=None,
) -> list:
    """Empty period-stacked caches sized for a context of ``length_hint``
    (Mamba slots: zero states; ``enc_len``: zero cross K/V in an
    encoder–decoder); ``device=None`` means the card (``device.resolve``).
    With ``mesh``: ``DTensor``s placed by ``sharding.cache_specs``, each rank
    allocating its own shards."""
    device = resolve(device)
    if mesh is not None:
        return _placed(init_decode_caches(cfg, batch, length_hint, policy=policy, enc_len=enc_len,
                                          device="meta"), cfg, mesh, device)
    check_supported(cfg)
    P = cfg.n_periods
    caches = []
    for kind in cfg.layout:
        if kind == "mamba":
            caches.append(ssm_mod.init_mamba_state(cfg, batch, DTYPES[cfg.dtype], device,
                                                   lead=(P,))._asdict())
            continue
        c = kvcache.init_cache(cfg, batch, length_hint, policy, stack=P, device=device)
        if cfg.n_enc_layers and enc_len:
            shape = (P, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
            c["cross_k"] = torch.zeros(shape, dtype=DTYPES[cfg.dtype], device=device)
            c["cross_v"] = torch.zeros(shape, dtype=DTYPES[cfg.dtype], device=device)
        caches.append(c)
    return caches


@torch.no_grad()
def decode_step(
    params: dict,
    token: torch.Tensor,  # (B,) or (B, 1)
    caches: list,
    length,  # () or (B,) live context length, on the device
    cfg: ModelConfig,
    active: torch.Tensor | None = None,  # (B,) bool — rows whose state may move
) -> tuple[torch.Tensor, list]:
    """One serve step → (logits (B, V), caches written in place) — and the
    summed counter vector when ``cfg.instrument``.

    ``active`` gates the Mamba state writes of rows mid-chunked-prefill:
    their KV appends already drop (page table −1), but the batch-wide
    recurrence would overwrite their conv/SSD rows.

    On a mesh every block's output is reduced before its residual add
    (``reduce_partial``: an all-reduce of the heads', channels' or hidden
    units' partial sums over ``'model'``): left pending, DTensor's rule for
    the add decides where they are reduced, and torch versions decide
    differently (2.11 at the add, 2.13 at the next norm)."""
    check_supported(cfg)
    token = token.reshape(token.shape[0], 1)
    x = embed(params["embed"], token).to(DTYPES[cfg.dtype])
    B = x.shape[0]
    pos = torch.as_tensor(length, dtype=torch.int32, device=x.device).expand(B)
    positions = pos[:, None]
    with _scope(cfg) as t:
        for i in range(cfg.n_periods):
            x = constrain(x, ("batch", None, None))
            for slot, kind in enumerate(cfg.layout):
                sp = layer_params(params["layers"][slot], i)
                c = kvcache.period_view(caches[slot], i)
                h = rms_norm(x, sp["norm1"], cfg.norm_eps)
                if kind == "mamba":
                    y, st = ssm_mod.mamba_decode_step(
                        sp["mamba"], h, ssm_mod.MambaState(c["conv"], c["ssd"]), cfg)
                    x = x + reduce_partial(y)
                    new_conv, new_ssd = st.conv, st.ssd
                    if active is not None:
                        keep = active[:, None, None]
                        new_conv = torch.where(keep, new_conv, c["conv"])
                        new_ssd = torch.where(keep[..., None], new_ssd, c["ssd"])
                    _copy_into(c["conv"], new_conv)
                    _copy_into(c["ssd"], new_ssd)
                    continue
                q, k, v = project_qkv(sp["attn"], h, cfg, positions)
                kv = {key: val for key, val in c.items() if not key.startswith("cross")}
                kvcache.append(kv, k, v, pos, cfg)
                x = x + reduce_partial(project_out(sp["attn"], kvcache.attend(kv, q, pos + 1, cfg)))
                if "cross_k" in c:
                    enc_len = c["cross_k"].shape[-3]
                    full = torch.full((B,), enc_len, dtype=torch.int32, device=x.device)
                    x = _cross(sp, x, c["cross_k"], c["cross_v"], cfg,
                               lambda q_, k_, v_: kvcache.attend({"k": k_, "v": v_}, q_, full, cfg),
                               settle=reduce_partial)
                x = _mlp_or_moe(sp, x, slot, cfg, settle=reduce_partial)
    return _with_counters(cfg, (logits_from_hidden(params, x[:, 0], cfg), caches), t, x.device)
