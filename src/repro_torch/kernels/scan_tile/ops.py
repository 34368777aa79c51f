"""Public wrapper of the row scan (K1) — port of ``scan_tile/ops.py``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.scan_tile import kernel as _kernel
from repro_torch.kernels.scan_tile import ref as _ref

__all__ = ["row_scan"]


def row_scan(x: torch.Tensor) -> torch.Tensor:
    """Per-row inclusive prefix sum of ``x: (rows, cols)``."""
    if x.ndim != 2:
        raise ValueError(f"expected (rows, cols), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return _ref.row_scan(x)
    return _kernel.row_scan_cuda(x.contiguous())
