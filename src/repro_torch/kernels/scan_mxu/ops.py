"""Public wrapper of the tensor-core scan (K2) — port of ``scan_mxu/ops.py``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The reference pads to its (8, 128) tiles; the kernel masks its own
ragged edges, so nothing is padded here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.scan_mxu import kernel as _kernel
from repro_torch.kernels.scan_mxu import ref as _ref

__all__ = ["row_scan"]


def row_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive per-row prefix sum of ``x: (rows, cols)``, in ``x``'s dtype."""
    if x.ndim != 2:
        raise ValueError(f"expected (rows, cols), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return _ref.row_scan(x)
    return _kernel.row_scan_mxu_cuda(x.contiguous())
