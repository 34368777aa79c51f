"""Flash attention wrapper (K13) — port of ``flash_attention/ops.py``.

``flash_attention`` keeps the reference's (BH, S, D) signature and its shape
contract: the sequence lengths must divide by the tile sizes the reference
picks (``bq = min(256, Sq)``, ``bk = min(256, Skv)`` unless given), or it
raises the reference's ``ValueError``, so both packages accept the same
inputs.  ``flash_attention_bhsd`` is the strided entry the model uses.  A CPU
tensor takes the plain version (``ref.attention``); a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref

__all__ = ["flash_attention", "flash_attention_bhsd", "DEFAULT_BQ", "DEFAULT_BK"]

DEFAULT_BQ = 256  # the reference kernel's tiles
DEFAULT_BK = 256


def _check_tiles(Sq: int, Skv: int, bq: int | None, bk: int | None) -> None:
    bq = min(DEFAULT_BQ, Sq) if bq is None else bq
    bk = min(DEFAULT_BK, Skv) if bk is None else bk
    if Sq % bq or Skv % bk:
        raise ValueError(f"unpadded seq: Sq={Sq} Skv={Skv}; pad to ({bq},{bk})")


def flash_attention_bhsd(
    q: torch.Tensor,  # (B, H, Sq, D), any strides with the last one 1
    k: torch.Tensor,  # (B, KH, Skv, D)
    v: torch.Tensor,
    out: torch.Tensor,  # (B, H, Sq, D), written in place
    *,
    group: int = 1,
    causal: bool = True,
    sm_scale: float | None = None,
    bq: int | None = None,
    bk: int | None = None,
) -> torch.Tensor:
    """Softmax attention of strided (B, H, S, D) views into ``out`` → ``out``."""
    B, H, Sq, D = q.shape
    _check_tiles(Sq, k.shape[2], bq, bk)
    scale = D ** -0.5 if sm_scale is None else sm_scale
    if q.device.type == "cpu":
        got = _ref.attention(q.reshape(B * H, Sq, D), k.reshape(-1, k.shape[2], D),
                             v.reshape(-1, v.shape[2], D), group=group, causal=causal,
                             sm_scale=scale)
        out.copy_(got.reshape(B, H, Sq, D))
        return out
    return _kernel.flash_attention_cuda(q, k, v, out, group=group, causal=causal, sm_scale=scale)


def flash_attention(
    q: torch.Tensor,  # (BH, Sq, D)
    k: torch.Tensor,  # (BH_kv, Skv, D)
    v: torch.Tensor,
    *,
    group: int = 1,
    causal: bool = True,
    bq: int | None = None,
    bk: int | None = None,
) -> torch.Tensor:
    """Softmax attention over (BH, S, D) tensors; GQA via ``group``."""
    out = torch.empty_like(q)
    flash_attention_bhsd(q[None], k[None], v[None], out[None], group=group, causal=causal,
                         bq=bq, bk=bk)
    return out
