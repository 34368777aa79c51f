"""Modality frontend stubs — port of ``repro/models/frontends.py``.

The vision and audio frontends are stubs in the reference too: these draw
the precomputed patch or frame embeddings the backbone consumes, N(0, 0.02²)
on the generator's device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DTYPES

__all__ = ["synthetic_prefix_embeds", "synthetic_frames"]


def synthetic_prefix_embeds(gen: torch.Generator, cfg: ModelConfig, batch: int,
                            dtype: torch.dtype | None = None) -> torch.Tensor:
    """ViT-patch-embedding stand-ins: (B, n_prefix, d_model)."""
    dtype = DTYPES[cfg.dtype] if dtype is None else dtype
    shape = (batch, cfg.n_prefix_embeds, cfg.d_model)
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02).to(dtype)


def synthetic_frames(gen: torch.Generator, cfg: ModelConfig, batch: int, seq: int,
                     dtype: torch.dtype | None = None) -> torch.Tensor:
    """Audio frame-embedding stand-ins: (B, S_enc, d_model)."""
    dtype = DTYPES[cfg.dtype] if dtype is None else dtype
    return (torch.randn((batch, seq, cfg.d_model), generator=gen, device=gen.device) * 0.02).to(dtype)
