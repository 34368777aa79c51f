"""AdamW with f32 moments over (possibly bf16) params — port of
``repro/optim/adamw.py``.

The arithmetic is the reference's, op for op and in its order: the clip
scale from the global norm, the bias corrections, f32 moments, the
decoupled weight decay, the cast back to the parameter dtype.  The update
runs leaf by leaf and in place under ``torch.no_grad()`` (the moments and
the parameters are overwritten), in slices of at most ``CHUNK`` elements, so
its f32 temporaries stay a slice's size whatever the leaf's: a functional
update of llama4's 671 M-element expert leaf would hold its old and new f32
moments at once.  Elementwise arithmetic does not depend on the slicing, so
the values are the reference's.  ``update`` returns the same parameter and
moment trees it was given, and ``global_norm`` stays on the device: a step
makes no host sync.

On a mesh (``DTensor`` leaves) the moments take their parameter's layout,
each gradient is redistributed to it, and the update runs on the local
shards (it is elementwise); a shard's sum of squares is reduced over the
mesh dims that shard its leaf.  On a one-rank mesh the arithmetic is the
plain tensors' exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed.context import is_dtensor
from repro_torch.tree import leaves, tree_map

__all__ = ["AdamWConfig", "AdamWState", "init", "update", "global_norm", "CHUNK"]

_F32 = torch.float32
# Elements a slice of the in-place update (64 MB of f32 a temporary).
CHUNK = 1 << 24


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32, on the parameters' device
    m: dict
    v: dict


def init(params) -> AdamWState:
    def zeros32(p):
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=_F32, requires_grad=False)
        return torch.zeros(p.shape, dtype=_F32, device=p.device)

    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros32, params), v=tree_map(zeros32, params))


def _slices(n: int):
    return (slice(lo, min(lo + CHUNK, n)) for lo in range(0, n, CHUNK))


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    """sum(x²) in f32, a slice at a time; of a ``DTensor``, the local
    shard's, summed over the mesh dims that shard it."""
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        local = _sumsq(x.to_local())
        over = [Partial() if p.is_shard() else Replicate() for p in x.placements]
        return DTensor.from_local(local, x.device_mesh, over).full_tensor()
    flat = x.detach().reshape(-1)
    return sum((torch.sum(torch.square(flat[s].to(_F32))) for s in _slices(flat.numel())),
               torch.zeros((), dtype=_F32, device=x.device))


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf, in f32, on the leaves' device."""
    return torch.sqrt(sum(_sumsq(x) for x in leaves(tree)))


def _update_slice(p, g, m, v, scale, bc1, bc2, lr, cfg: AdamWConfig) -> None:
    """The reference's ``upd`` on one slice, in place; ``g32`` and ``t`` are
    the only f32 temporaries (a third, ``p32``, for 16-bit parameters)."""
    g32 = g.to(_F32) * scale
    t = g32 * (1 - cfg.b1)
    m.mul_(cfg.b1).add_(t)  # b1·m + (1 − b1)·g
    torch.square(g32, out=t)
    t.mul_(1 - cfg.b2)
    v.mul_(cfg.b2).add_(t)  # b2·v + (1 − b2)·g²
    torch.div(m, bc1, out=g32)  # m̂
    torch.div(v, bc2, out=t)  # v̂
    t.sqrt_().add_(cfg.eps)
    g32.div_(t)  # m̂ / (√v̂ + eps)
    p32 = p.to(_F32)
    torch.mul(p32, cfg.weight_decay, out=t)
    g32.add_(t).mul_(lr)  # lr · (m̂ / (√v̂ + eps) + wd · p32)
    torch.sub(p32, g32, out=g32)
    p.copy_(g32)  # back to the parameter dtype


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gradient in its parameter's layout (a pending sum
    reduced); a plain one unchanged."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def update(grads, state: AdamWState, params, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step, in place → (params, new state, grad_norm): the same
    ``params``, ``state.m`` and ``state.v`` trees, updated; a new step."""
    with torch.no_grad():
        grads = tree_map(_like, grads, params)
        gnorm = global_norm(grads)
        denom = torch.clamp(gnorm, min=1e-9)
        scale = torch.clamp(torch.full_like(denom, cfg.grad_clip) / denom, max=1.0)
        step = state.step + 1
        bc1 = 1 - cfg.b1 ** step.to(_F32)
        bc2 = 1 - cfg.b2 ** step.to(_F32)
        lr = cfg.lr * lr_scale
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m), leaves(state.v)):
            if is_dtensor(p):  # elementwise: the local shards, all four laid out alike
                p, g, m, v = (t.to_local() for t in (p, g, m, v))
            pf, gf, mf, vf = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
            for s in _slices(pf.numel()):
                _update_slice(pf[s], gf[s], mf[s], vf[s], scale, bc1, bc2, lr, cfg)
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
