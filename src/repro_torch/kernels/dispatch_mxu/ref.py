"""Plain PyTorch versions of dispatch (K5a) and combine (K5b) — port of
``dispatch_mxu/ref.py``: scatter-add and gather semantics, not the
reference kernel's f32 one-hot matrix product."""
from __future__ import annotations

import torch

__all__ = ["dispatch", "combine"]


def dispatch(x: torch.Tensor, pos: torch.Tensor, n_slots: int) -> torch.Tensor:
    """``out[pos[t]] += x[t]`` into ``(n_slots, *x.shape[1:])`` zeros, for
    ``0 <= pos[t] < n_slots``; other lanes are dropped."""
    pos = pos.reshape(-1)
    keep = (pos >= 0) & (pos < n_slots)
    out = torch.zeros((n_slots, *x.shape[1:]), dtype=x.dtype, device=x.device)
    src = torch.where(keep.reshape(-1, *(1,) * (x.ndim - 1)), x, torch.zeros_like(x))
    return out.index_add_(0, torch.where(keep, pos, 0).to(torch.int64), src)


def combine(buf: torch.Tensor, pos: torch.Tensor, n_out: int) -> torch.Tensor:
    """``out[t] = buf[pos[t]]`` (index clipped to the buffer), zeros where
    ``pos[t] < 0``."""
    pos = pos.reshape(-1)[:n_out]
    vals = buf[pos.clamp(0, buf.shape[0] - 1).to(torch.int64)]
    live = (pos >= 0).reshape(-1, *(1,) * (buf.ndim - 1))
    return torch.where(live, vals, torch.zeros_like(vals))
