"""Public wrappers of dispatch (K5a) and combine (K5b) — port of
``dispatch_mxu/ops.py``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The reference pads to its 128-row tiles; the kernels take any
length, so nothing is padded here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch_mxu import kernel as _kernel
from repro_torch.kernels.dispatch_mxu import ref as _ref

__all__ = ["dispatch", "combine"]


def dispatch(x: torch.Tensor, pos: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Scatter-add ``x: (T, D)`` rows to ``pos: (T,)`` slots of a
    ``(n_slots, D)`` zero buffer; slots outside ``[0, n_slots)`` drop."""
    if x.device.type == "cpu":
        return _ref.dispatch(x, pos, n_slots)
    pos = pos.reshape(-1).to(torch.int32).contiguous()
    return _kernel.dispatch_cuda(x.contiguous(), pos, n_slots)


def combine(buf: torch.Tensor, pos: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """Gather rows of ``buf: (S, D)`` at ``pos: (T,)`` (zeros where pos < 0)."""
    n_out = pos.reshape(-1).shape[0] if n_out is None else n_out
    if buf.device.type == "cpu":
        return _ref.combine(buf, pos, n_out)
    pos = pos.reshape(-1)[:n_out].to(torch.int32).contiguous()
    return _kernel.combine_cuda(buf.contiguous(), pos)
