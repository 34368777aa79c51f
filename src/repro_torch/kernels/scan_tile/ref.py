"""Plain PyTorch version of the row scan (K1) — port of ``scan_tile/ref.py``."""
from __future__ import annotations

import torch

__all__ = ["row_scan"]


def row_scan(x: torch.Tensor) -> torch.Tensor:
    """Per-row inclusive prefix sum, in ``x``'s dtype."""
    return torch.cumsum(x, dim=-1, dtype=x.dtype)
