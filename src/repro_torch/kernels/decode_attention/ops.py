"""Flash-decode wrapper (K14) — port of ``decode_attention/ops.py``.

``decode_attention`` keeps the reference's signature: flat query heads
``(B, H, D)`` against a ``(B, KH, S, D)`` cache (any strides with the last
one 1) and live ``lengths``.  ``bk``, the reference's KV block, is kept
for its signature and has no effect: the kernel splits the cache into its
own segments and masks ragged ends, so nothing is padded.  A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.decode_attention import kernel as _kernel
from repro_torch.kernels.decode_attention import ref as _ref

__all__ = ["decode_attention"]


def decode_attention(
    q: torch.Tensor,  # (B, H, D) flat query heads
    k: torch.Tensor,  # (B, KH, S, D)
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) or (B, 1)
    *,
    bk: int | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """One-token attention against a (possibly partly filled) KV cache → (B, H, D)."""
    B, H, D = q.shape
    KH = k.shape[1]
    if bk is not None and bk < 1:
        raise ValueError(f"bk must be positive, got {bk}")
    if H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} kv heads")
    qg = q.reshape(B, KH, H // KH, D)
    lengths = lengths.reshape(B)
    scale = D ** -0.5 if sm_scale is None else sm_scale
    if common.on_cpu(q):
        out = _ref.decode_attention(qg, k, v, lengths, sm_scale=scale)
    else:
        out = common.run_kernel(
            "decode_attention", [qg, k, v, lengths],
            lambda: _ref.decode_attention(qg, k, v, lengths, sm_scale=scale),
            lambda: _kernel.decode_attention_cuda(qg.contiguous(), k, v,
                                                  lengths.to(torch.int32).contiguous(), sm_scale=scale))
    return out.reshape(B, H, D)
