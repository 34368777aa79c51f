"""Plain PyTorch version of flash attention (K13) — port of
``flash_attention/ref.py``: exact softmax attention with GQA and causal
masking, in f32, output in ``q.dtype``.  The wrapper takes it for CPU
tensors; ``chip_smoke.py`` holds the CUDA kernel against it on the card."""
from __future__ import annotations

import torch

__all__ = ["attention"]


def attention(
    q: torch.Tensor,  # (BH, Sq, D)
    k: torch.Tensor,  # (BH_kv, Skv, D)
    v: torch.Tensor,
    *,
    group: int = 1,
    causal: bool = True,
    sm_scale: float | None = None,
) -> torch.Tensor:
    BH, Sq, D = q.shape
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    kk = torch.repeat_interleave(k, group, dim=0)
    vv = torch.repeat_interleave(v, group, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.to(torch.float32), kk.to(torch.float32)) * sm_scale
    if causal:
        Skv = k.shape[1]
        mask = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(mask[None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, vv.to(torch.float32)).to(q.dtype)
