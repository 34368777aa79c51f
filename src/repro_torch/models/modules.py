"""Shared model building blocks — port of ``repro/models/modules.py``.

Norms, rotary embeddings, embeddings and the scaled-normal initialiser.  The
arithmetic follows the reference step by step (f32 inside the norm and the
rotation, the input dtype at the boundary, f32 logits), so both packages
compute the same function on the same parameters.  The reference's
hand-written VJP of ``rms_norm`` has no counterpart: the port serves and
does not differentiate.  ``dense_init`` takes an explicit
``torch.Generator``; JAX's PRNG does not carry over, so parity tests hand
the reference's parameters across with ``convert.params_from_numpy``.
"""
from __future__ import annotations

from typing import Any

import torch

__all__ = ["rms_norm", "rope", "apply_rope", "embed", "unembed", "dense_init", "Param", "DTYPES"]

Param = dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dense_init(
    gen: torch.Generator,
    shape: tuple[int, ...],
    dtype: torch.dtype,
    fan_in: int | None = None,
    *,
    lead: tuple[int, ...] = (),
    device: "torch.device | str | None" = None,
) -> torch.Tensor:
    """Scaled normal init (1/sqrt(fan_in)) drawn from ``gen``, shape
    ``(*lead, *shape)``.

    ``lead`` holds stacking dims (periods, experts): each ``shape`` slice
    is drawn in f32 in turn, row-major over ``lead``, and cast into the
    ``dtype`` leaf, so the f32 temporary is one slice, never the leaf
    (dbrx's ``w_gate`` at 8 layers would be a 34 GB f32 draw).
    """
    fan_in = shape[0] if fan_in is None else fan_in
    dev = gen.device if device is None else device
    out = torch.empty((*lead, *shape), dtype=dtype, device=dev)
    for piece in out.view(-1, *shape) if lead else (out,):
        piece.copy_(torch.randn(shape, generator=gen, device=dev) * (fan_in ** -0.5))
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: f32 inside, ``x.dtype`` out."""
    x32 = x.to(torch.float32)
    rstd = torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True) + eps)
    return (x32 * rstd * weight.to(torch.float32)).to(x.dtype)


def rope(positions: torch.Tensor, dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding at ``positions`` (..., seq)."""
    dev = positions.device
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim))
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., seq, dim/2)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate head vectors. x: (..., seq, heads, head_dim); cos/sin (..., seq, hd/2)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits (fp32 for a stable softmax/CE)."""
    return torch.matmul(x.to(torch.float32), table.to(torch.float32).t())
