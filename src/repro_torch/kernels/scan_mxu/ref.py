"""Plain PyTorch version of the tensor-core scan (K2) — port of ``scan_mxu/ref.py``."""
from __future__ import annotations

import torch

__all__ = ["row_scan"]


def row_scan(x: torch.Tensor) -> torch.Tensor:
    """Per-row inclusive prefix sum, in ``x``'s dtype (int32 wraps modulo 2^32)."""
    return torch.cumsum(x, dim=-1, dtype=x.dtype)
