"""Encoder stack for encoder–decoder models (seamless-m4t backbone) — port
of ``repro/models/encdec.py``.

The encoder consumes precomputed frame embeddings (the audio frontend is a
stub, ``models/frontends.synthetic_frames``) through bidirectional
attention layers; the decoder (``models/transformer.py``) cross-attends to
its output.  Encoder leaves are stacked over ``n_enc_layers``, as the
reference's ``vmap`` stacks them, and the port loops where it scans (each
leaf unbound once; each layer checkpointed under ``cfg.remat``, as the
reference's ``jax.checkpoint(body)``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import constrain
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.modules import DTYPES, Param, rms_norm

__all__ = ["init_encoder", "encode"]


def init_encoder(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Param:
    n, d, dev = cfg.n_enc_layers, cfg.d_model, gen.device
    layers = {
        "norm1": torch.ones((n, d), dtype=dtype, device=dev),
        "attn": attn_mod.init_attention(gen, cfg, dtype, lead=(n,)),
        "norm2": torch.ones((n, d), dtype=dtype, device=dev),
        "mlp": mlp_mod.init_mlp(gen, d, cfg.d_ff, cfg.activation, dtype, lead=(n,)),
    }
    return {"layers": layers, "final_norm": torch.ones((d,), dtype=dtype, device=dev)}


def encode(enc_params: Param, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings → encoder memory (B, S_enc, D)."""
    from repro_torch.models.transformer import run_periods, unstack_layers

    x = frames.to(DTYPES[cfg.dtype])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    layers = unstack_layers(enc_params["layers"], cfg.n_enc_layers)

    def body(i: int, x: torch.Tensor):
        # the decoder's residual layout (transformer.forward): on a mesh the
        # attention's and the MLP's head- and ff-partial sums then
        # reduce-scatter onto the sequence at the residual adds, where a
        # replicated stream left the choice to a torch version's rule
        # (2.13 reduce-scattered at the next norm, 2.11 all-reduced)
        x = constrain(x, ("batch", "seq", None))
        lp = layers[i]
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        x = x + attn_mod.attention_block(lp["attn"], h, cfg, positions, causal=False)
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        return (x + mlp_mod.mlp_block(lp["mlp"], h, cfg.activation),)

    (x,) = run_periods(body, (x,), cfg.n_enc_layers, cfg.remat)
    return rms_norm(x, enc_params["final_norm"], cfg.norm_eps)
