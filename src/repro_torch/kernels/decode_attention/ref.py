"""Plain PyTorch version of flash-decode (K14) — port of
``decode_attention/ref.py``.

One difference from the reference's oracle: a sequence of length 0 returns
zeros, as the reference's kernel (``l`` clamped at 1e-30) and
``kvcache.attend`` do, where the oracle's ``-inf`` softmax gives NaN.
"""
from __future__ import annotations

import torch

__all__ = ["decode_attention"]


def decode_attention(
    q: torch.Tensor,  # (B, KH, G, D)
    k: torch.Tensor,  # (B, KH, S, D), any strides
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) or (B, 1)
    *,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Masked softmax attention of one query per sequence → (B, KH, G, D) in ``q.dtype``."""
    D = q.shape[-1]
    S = k.shape[2]
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    f32 = torch.float32
    s = torch.einsum("bhgd,bhsd->bhgs", q.to(f32), k.to(f32)) * sm_scale
    live = (torch.arange(S, device=q.device)[None, :] < lengths.reshape(-1, 1))[:, None, None, :]
    m = torch.amax(torch.where(live, s, -torch.inf), dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # length 0: no live key
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return (torch.einsum("bhgs,bhsd->bhgd", p, v.to(f32)) / l).to(q.dtype)
