"""Deterministic synthetic data: step-indexed batches — port of
``repro/data/synthetic.py``.

Every batch is a pure function of (seed, step): ``make_batch`` draws on a
``torch.Generator`` seeded from the pair, so a restarted loop regenerates
exactly the batches it would have seen.  JAX's PRNG does not carry over,
so the values differ from the reference's; the keys, shapes and dtypes are
the reference's (``batch_spec``), and parity tests feed both packages the
same numpy batches.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.transformer import DTYPES

__all__ = ["make_batch", "batch_spec", "TensorSpec"]


class TensorSpec(NamedTuple):
    """Shape and dtype of one batch entry (the reference's ShapeDtypeStruct)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def _step_generator(seed: int, step: int, device: "torch.device | str | None" = None) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step) — distinct pairs
    give independent streams (numpy's ``SeedSequence`` mixes the two)."""
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1))
    return gen


def batch_spec(cfg: ModelConfig, batch: int, seq: int) -> dict[str, TensorSpec]:
    """The shapes and dtypes ``make_batch`` returns (dry-run input specs)."""
    out = {"tokens": TensorSpec((batch, seq), torch.int32)}
    dt = DTYPES[cfg.dtype]
    if cfg.n_enc_layers:
        out["frames"] = TensorSpec((batch, seq, cfg.d_model), dt)
    elif cfg.n_prefix_embeds:
        out["prefix_embeds"] = TensorSpec((batch, cfg.n_prefix_embeds, cfg.d_model), dt)
    return out


def make_batch(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    *,
    seed: int = 0,
    step: int = 0,
    device: "torch.device | str | None" = None,
) -> dict[str, torch.Tensor]:
    """Synthetic batch matching ``batch_spec``: tokens uniform over the
    vocab; encoder frames or prefix embeddings N(0, 0.02²) where the family
    has them.  ``device=None`` means the card."""
    gen = _step_generator(seed, step, device)
    dev = gen.device
    out = {}
    for key, spec in batch_spec(cfg, batch, seq).items():
        if key == "tokens":
            out[key] = torch.randint(0, cfg.vocab_size, spec.shape, generator=gen, device=dev,
                                     dtype=torch.int32)
        else:
            out[key] = (torch.randn(spec.shape, generator=gen, device=dev) * 0.02).to(spec.dtype)
    return out
