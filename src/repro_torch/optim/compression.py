"""Gradient compression with error feedback — port of
``repro/optim/compression.py``.

Per-tensor symmetric int8 quantisation (the reference's two divisions,
round half to even, clip to ±127); the quantisation error is carried in an
f32 residual and added back next step (1-bit-Adam lineage).  The residual
is updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["EFState", "ef_init", "quantize", "dequantize", "compress_grads"]

_F32 = torch.float32


class EFState(NamedTuple):
    residual: dict  # the grads' tree, f32


def ef_init(grads_like) -> EFState:
    return EFState(residual=tree_map(lambda g: torch.zeros(g.shape, dtype=_F32, device=g.device),
                                     grads_like))


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float → (int8, scale). Symmetric, per tensor."""
    x32 = x.to(_F32)
    scale = torch.clamp(torch.amax(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(_F32) * scale


def compress_grads(grads, ef: EFState) -> tuple[dict, EFState]:
    """Quantise-dequantise each grad with error feedback → (grads', ef);
    ``ef.residual`` is overwritten with the new error."""
    out = []
    with torch.no_grad():
        for g, r in zip(leaves(grads), leaves(ef.residual)):
            full = g.to(_F32) + r
            deq = dequantize(*quantize(full))
            r.copy_(full - deq)
            out.append(deq.to(g.dtype))
    return unflatten(grads, out), ef
