"""Decoder stack — port of ``repro/models/transformer.py``, attention-only
layouts.

The parameter tree is the reference's: ``{"embed", "final_norm",
"layers": [slot params …], ("unembed")}`` with every layer leaf stacked
along a leading period axis (``n_periods``), so ``convert.params_from_numpy``
carries the reference's parameters over leaf for leaf.  Where the reference
scans a period body, the port loops over periods and indexes each leaf
(``layer_params``, a view, never a copy).  Mamba, MoE, encoder–decoder and
multimodal prefix embeddings raise ``NotImplementedError`` (ROADMAP.md,
Queue 1 item 16).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.modules import Param, embed, rms_norm, unembed

__all__ = ["init_params", "forward", "layer_params", "check_supported", "DTYPES"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the layouts the port does not serve yet."""
    what = None
    if any(kind != "attn" for kind in cfg.layout):
        what = f"layout {cfg.layout} (Mamba / hybrid)"
    elif cfg.moe is not None:
        what = "MoE layers"
    elif cfg.n_enc_layers:
        what = "encoder–decoder stacks"
    elif cfg.n_prefix_embeds:
        what = "multimodal prefix embeddings"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} are not ported yet (ROADMAP.md, Queue 1 item 16)"
        )


def layer_params(tree: Any, i: int) -> Any:
    """Period ``i`` of a stacked layer tree: every leaf indexed on axis 0."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Param:
    """Random parameters on ``gen``'s device (the reference's initialiser:
    scaled normals, unit norms, zero biases, embedding std 0.02)."""
    check_supported(cfg)
    dtype = DTYPES[cfg.param_dtype]
    dev = gen.device
    P, d = cfg.n_periods, cfg.d_model
    lead = (P,)
    layers = []
    for _slot in cfg.layout:
        layers.append({
            "norm1": torch.ones((P, d), dtype=dtype, device=dev),
            "attn": attn_mod.init_attention(gen, cfg, dtype, lead=lead),
            "norm2": torch.ones((P, d), dtype=dtype, device=dev),
            "mlp": mlp_mod.init_mlp(gen, d, cfg.d_ff, cfg.activation, dtype, lead=lead),
        })

    def table():
        return (torch.randn((cfg.padded_vocab, d), generator=gen, device=dev) * 0.02).to(dtype)

    params: Param = {
        "embed": table(),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = table()
    return params


def _apply_slot(sp: Param, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, sp["norm1"], cfg.norm_eps)
    x = x + attn_mod.attention_block(sp["attn"], h, cfg, positions)
    h = rms_norm(x, sp["norm2"], cfg.norm_eps)
    return x + mlp_mod.mlp_block(sp["mlp"], h, cfg.activation)


def forward(
    params: Param,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    prefix_embeds: torch.Tensor | None = None,
    memory: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B, S, V) f32, aux_loss = 0)."""
    check_supported(cfg)
    if prefix_embeds is not None or memory is not None:
        raise NotImplementedError(
            "prefix embeddings and encoder memory are not ported yet (ROADMAP.md, Queue 1 item 16)"
        )
    x = embed(params["embed"], tokens).to(DTYPES[cfg.dtype])
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    for i in range(cfg.n_periods):
        for slot in range(len(cfg.layout)):
            x = _apply_slot(layer_params(params["layers"][slot], i), x, cfg, positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed(x, table)
    if cfg.padded_vocab != cfg.vocab_size:  # mask vocab-padding columns
        live = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(live, logits, -1e30)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
