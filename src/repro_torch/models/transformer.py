"""Decoder stack: period-stacked heterogeneous layers — port of
``repro/models/transformer.py``.

``cfg.layout`` lists the layer kinds of one period (dense: ``("attn",)``;
Jamba: seven Mamba slots and one attention slot).  The parameter tree is
the reference's: ``{"embed", "final_norm", "layers": [slot params …],
("unembed"), ("encoder")}`` with every layer leaf stacked along a leading
period axis (``n_periods``), so ``convert.params_from_numpy`` carries the
reference's parameters over leaf for leaf.  A slot holds ``norm1`` and
``mamba``, or ``norm1``, ``attn``, ``norm2`` and ``moe`` or ``mlp`` (and
``cross_norm`` / ``cross`` in an encoder–decoder).  A Mamba slot has no
MLP, so it never gets an MoE — the reference's rule, which leaves Jamba's
MoE slots (1, 3, 5, 7: all Mamba) without experts.  Where the reference
scans a period body, the port loops over periods and indexes each leaf
(``layer_params``, a view, never a copy).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.modules import DTYPES, Param, embed, rms_norm, unembed

__all__ = ["init_params", "forward", "layer_params", "check_supported", "DTYPES"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configurations the port cannot serve: every layer kind of
    the reference (``attn``, ``mamba``) is ported."""
    bad = [kind for kind in cfg.layout if kind not in ("attn", "mamba")]
    if bad:
        raise ValueError(f"{cfg.name}: unknown layer kinds {bad}")
    if "mamba" in cfg.layout and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: a Mamba layout needs an ssm config")


def layer_params(tree: Any, i: int) -> Any:
    """Period ``i`` of a stacked layer tree: every leaf indexed on axis 0."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def _init_slot(gen: torch.Generator, slot: int, kind: str, cfg: ModelConfig,
               dtype: torch.dtype) -> Param:
    P, d, dev = cfg.n_periods, cfg.d_model, gen.device
    lead = (P,)

    def ones():
        return torch.ones((P, d), dtype=dtype, device=dev)

    p: Param = {"norm1": ones()}
    if kind == "mamba":
        p["mamba"] = ssm_mod.init_mamba(gen, cfg, dtype, lead=lead)
        return p
    p["attn"] = attn_mod.init_attention(gen, cfg, dtype, lead=lead)
    p["norm2"] = ones()
    if cfg.is_moe_layer(slot):
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype, lead=lead)
    else:
        p["mlp"] = mlp_mod.init_mlp(gen, d, cfg.d_ff, cfg.activation, dtype, lead=lead)
    if cfg.n_enc_layers:  # encoder–decoder: a cross-attention sub-block
        p["cross_norm"] = ones()
        p["cross"] = attn_mod.init_attention(gen, cfg, dtype, lead=lead)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Param:
    """Random parameters on ``gen``'s device (the reference's initialiser:
    scaled normals, unit norms, zero biases, embedding std 0.02), drawn
    one period (and expert) slice at a time."""
    check_supported(cfg)
    dtype = DTYPES[cfg.param_dtype]
    dev = gen.device
    d = cfg.d_model

    def table():
        return (torch.randn((cfg.padded_vocab, d), generator=gen, device=dev) * 0.02).to(dtype)

    params: Param = {
        "embed": table(),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
        "layers": [_init_slot(gen, slot, kind, cfg, dtype) for slot, kind in enumerate(cfg.layout)],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = table()
    if cfg.n_enc_layers:
        from repro_torch.models import encdec

        params["encoder"] = encdec.init_encoder(gen, cfg, dtype)
    return params


def _apply_slot(sp: Param, x: torch.Tensor, kind: str, slot: int, cfg: ModelConfig,
                positions: torch.Tensor, memory_kv) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer → (x, its MoE aux loss or None)."""
    h = rms_norm(x, sp["norm1"], cfg.norm_eps)
    if kind == "mamba":
        return x + ssm_mod.mamba_block(sp["mamba"], h, cfg), None
    x = x + attn_mod.attention_block(sp["attn"], h, cfg, positions)
    if memory_kv is not None:
        h = rms_norm(x, sp["cross_norm"], cfg.norm_eps)
        x = x + attn_mod.attention_block(sp["cross"], h, cfg, positions, kv=memory_kv)
    h = rms_norm(x, sp["norm2"], cfg.norm_eps)
    if cfg.is_moe_layer(slot):
        out, aux = moe_mod.moe_block(sp["moe"], h, cfg)
        return x + out, aux
    return x + mlp_mod.mlp_block(sp["mlp"], h, cfg.activation), None


def forward(
    params: Param,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    prefix_embeds: torch.Tensor | None = None,
    memory: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B, P + S, V) f32, aux_loss f32).

    ``prefix_embeds``: (B, P, D) multimodal stub embeddings prepended to the
    token embeddings.  ``memory``: (B, S_enc, D) encoder output, which each
    attention slot projects with its own cross-attention weights.
    """
    check_supported(cfg)
    x = embed(params["embed"], tokens).to(DTYPES[cfg.dtype])
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_periods):
        for slot, kind in enumerate(cfg.layout):
            sp = layer_params(params["layers"][slot], i)
            mkv = None
            if memory is not None and kind == "attn":
                mkv = (attn_mod.project_heads(memory, sp["cross"]["wk"]),
                       attn_mod.project_heads(memory, sp["cross"]["wv"]))
            x, a = _apply_slot(sp, x, kind, slot, cfg, positions, mkv)
            if a is not None:
                aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed(x, table)
    if cfg.padded_vocab != cfg.vocab_size:  # mask vocab-padding columns
        live = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(live, logits, -1e30)
    return logits, aux
