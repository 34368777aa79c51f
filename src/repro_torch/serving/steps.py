"""Serving steps — port of ``repro/serving/steps.py``: prefill (context
encode → cache), chunked prefill into shared paged caches, and decode (one
token).

Where the reference scans a period body and threads the caches through the
scan (donated, updated by dynamic-update-slice), the port loops over periods
and writes each period's cache views in place (``kvcache.period_view``).
``constrain`` (the reference's sharding annotation) is the identity on one
card and is dropped.  Attention-only layouts; others raise
``NotImplementedError`` (``models.transformer.check_supported``).

With ``cfg.instrument`` each step opens one ``obs.device.tape()`` (the
reference opens one per scan iteration; PyTorch traces nothing) and returns
the sum of the counter vectors the cache ops recorded as an extra output —
device data, no transfer.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.attention import inner_attention, project_out, project_qkv
from repro_torch.models.mlp import mlp_block
from repro_torch.models.modules import embed, rms_norm, unembed
from repro_torch.models.transformer import DTYPES, check_supported, layer_params
from repro_torch.obs import device as obs_device
from repro_torch.serving import kvcache

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
    logits = unembed(x, table)
    if cfg.padded_vocab != cfg.vocab_size:
        live = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(live, logits, -1e30)
    return logits


def _mlp(sp, x, cfg):
    return x + mlp_block(sp["mlp"], rms_norm(x, sp["norm2"], cfg.norm_eps), cfg.activation)


def _scope(cfg: ModelConfig):
    """One counter tape per step when ``cfg.instrument``, else nothing."""
    return obs_device.tape() if cfg.instrument else contextlib.nullcontext()


def _with_counters(cfg: ModelConfig, out: tuple, t, device) -> tuple:
    """Append the tape's total to a step's outputs when ``cfg.instrument``."""
    return (*out, t.total(device)) if cfg.instrument else out


def _check_stack(cfg: ModelConfig, prefix_embeds=None, memory=None) -> None:
    check_supported(cfg)
    if prefix_embeds is not None or memory is not None:
        raise NotImplementedError(
            "prefix embeddings and encoder memory are not ported yet (ROADMAP.md, Queue 1 item 16)"
        )


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
    prefill has no counted kernel, as in the reference)."""
    _check_stack(cfg, prefix_embeds, memory)
    policy = cfg.cache_policy if policy is None else policy
    x = embed(params["embed"], tokens).to(DTYPES[cfg.dtype])
    B, S, _ = x.shape
    dev = x.device
    cap = capacity_hint if capacity_hint is not None else S
    positions = torch.arange(S, device=dev)[None, :]
    caches = [kvcache.init_cache(cfg, B, cap, policy, stack=cfg.n_periods, device=dev)
              for _ in cfg.layout]
    with _scope(cfg) as t:
        for i in range(cfg.n_periods):
            for slot in range(len(cfg.layout)):
                sp = layer_params(params["layers"][slot], i)
                h = rms_norm(x, sp["norm1"], cfg.norm_eps)
                q, k, v = project_qkv(sp["attn"], h, cfg, positions)
                x = x + project_out(sp["attn"], inner_attention(q, k, v, cfg, causal=True))
                kvcache.fill_from_prefill(kvcache.period_view(caches[slot], i), k, v)
                x = _mlp(sp, x, cfg)
    if lengths is None:
        last = x[:, -1]
    else:
        idx = torch.as_tensor(lengths, device=dev).long() - 1
        last = x[torch.arange(B, device=dev), idx]
    return _with_counters(cfg, (logits_from_hidden(params, last, cfg), caches), t, dev)


def prefill_chunk(
    params: dict,
    tokens: torch.Tensor,  # (1, Cb) bucket-padded chunk of one prompt
    caches: list,  # the BatchEngine's shared caches, written in place
    slot: int,  # decode slot owning this prompt (used by SSM layers only)
    t0: int,  # prompt tokens already prefilled
    live: int,  # live tokens in this chunk (Cb − live are padding)
    pages_row: torch.Tensor,  # (maxp,) the slot's claimed slab ids, −1-padded
    cfg: ModelConfig,
    first: bool = True,  # t0 == 0: no prefix to attend
) -> tuple[torch.Tensor, list]:
    """→ (last-live-position logits (1, V), caches) — and the summed counter
    vector when ``cfg.instrument``.  ``t0`` and ``live`` are the scheduler's
    host ints."""
    _check_stack(cfg)
    x = embed(params["embed"], tokens).to(DTYPES[cfg.dtype])
    Cb = tokens.shape[1]
    positions = (t0 + torch.arange(Cb, device=x.device))[None, :]
    with _scope(cfg) as t:
        for i in range(cfg.n_periods):
            for lslot in range(len(cfg.layout)):
                sp = layer_params(params["layers"][lslot], i)
                c = kvcache.period_view(caches[lslot], i)
                h = rms_norm(x, sp["norm1"], cfg.norm_eps)
                q, k, v = project_qkv(sp["attn"], h, cfg, positions)
                att = kvcache.chunk_attend(c, pages_row, q, k, v, t0, live, cfg, first=first)
                x = x + project_out(sp["attn"], att)
                kvcache.scatter_chunk(c, pages_row, k, v, t0, live, cfg)
                x = _mlp(sp, x, cfg)
    out = (logits_from_hidden(params, x[0, live - 1][None], cfg), caches)
    return _with_counters(cfg, out, t, x.device)


def init_decode_caches(
    cfg: ModelConfig,
    batch: int,
    length_hint: int,
    *,
    policy: str | None = None,
    device: "torch.device | str | None" = None,
) -> list:
    """Empty period-stacked caches sized for a context of ``length_hint``;
    ``device=None`` means the card (``device.resolve``)."""
    device = resolve(device)
    _check_stack(cfg)
    return [kvcache.init_cache(cfg, batch, length_hint, policy, stack=cfg.n_periods, device=device)
            for _ in cfg.layout]


def decode_step(
    params: dict,
    token: torch.Tensor,  # (B,) or (B, 1)
    caches: list,
    length,  # () or (B,) live context length, on the device
    cfg: ModelConfig,
    active: torch.Tensor | None = None,
) -> tuple[torch.Tensor, list]:
    """One serve step → (logits (B, V), caches written in place) — and the
    summed counter vector when ``cfg.instrument``.

    ``active`` gates SSM state rows in the reference; attention-only stacks
    do not need it (inactive rows' appends drop through their −1 pages).
    """
    _check_stack(cfg)
    token = token.reshape(token.shape[0], 1)
    x = embed(params["embed"], token).to(DTYPES[cfg.dtype])
    B = x.shape[0]
    pos = torch.as_tensor(length, dtype=torch.int32, device=x.device).expand(B)
    positions = pos[:, None]
    with _scope(cfg) as t:
        for i in range(cfg.n_periods):
            for slot in range(len(cfg.layout)):
                sp = layer_params(params["layers"][slot], i)
                c = kvcache.period_view(caches[slot], i)
                h = rms_norm(x, sp["norm1"], cfg.norm_eps)
                q, k, v = project_qkv(sp["attn"], h, cfg, positions)
                kvcache.append(c, k, v, pos, cfg)
                x = x + project_out(sp["attn"], kvcache.attend(c, q, pos + 1, cfg))
                x = _mlp(sp, x, cfg)
    return _with_counters(cfg, (logits_from_hidden(params, x[:, 0], cfg), caches), t, x.device)
