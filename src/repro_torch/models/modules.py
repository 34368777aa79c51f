"""Shared model building blocks — port of ``repro/models/modules.py``.

Norms, rotary embeddings, embeddings and the scaled-normal initialiser.  The
arithmetic follows the reference step by step (f32 inside the norm and the
rotation, the input dtype at the boundary, f32 logits), so both packages
compute the same function on the same parameters.  ``rms_norm`` carries
the reference's hand-written VJP (``repro/models/modules.py:43-57``) as a
``torch.autograd.Function``: f32 math inside, the gradients in the input's
and the weight's dtypes.  ``dense_init`` takes an explicit
``torch.Generator``; JAX's PRNG does not carry over, so parity tests hand
the reference's parameters across with ``convert.params_from_numpy``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed.context import as_dtensor, is_dtensor, local_region, merge_ready, reduce_partial

__all__ = ["rms_norm", "rope", "apply_rope", "embed", "unembed", "dense_init", "Param", "DTYPES"]

Param = dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dense_init(
    gen: torch.Generator,
    shape: tuple[int, ...],
    dtype: torch.dtype,
    fan_in: int | None = None,
    *,
    lead: tuple[int, ...] = (),
    device: "torch.device | str | None" = None,
) -> torch.Tensor:
    """Scaled normal init (1/sqrt(fan_in)) drawn from ``gen``, shape
    ``(*lead, *shape)``.

    ``lead`` holds stacking dims (periods, experts): each ``shape`` slice
    is drawn in f32 in turn, row-major over ``lead``, and cast into the
    ``dtype`` leaf, so the f32 temporary is one slice, never the leaf
    (dbrx's ``w_gate`` at 8 layers would be a 34 GB f32 draw).
    """
    fan_in = shape[0] if fan_in is None else fan_in
    dev = gen.device if device is None else device
    out = torch.empty((*lead, *shape), dtype=dtype, device=dev)
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
        return out  # a fake tensor holds no values: shapes only (the dry-run's)
    for piece in out.view(-1, *shape) if lead else (out,):
        piece.copy_(torch.randn(shape, generator=gen, device=dev) * (fan_in ** -0.5))
    return out


def _rstd(x32: torch.Tensor, eps: float) -> torch.Tensor:
    """1 / RMS over the last dim; where a mesh shards that dim (Mamba's
    gated norm over the inner dim) the row statistics are reduced at once
    (``reduce_partial``)."""
    return torch.rsqrt(reduce_partial(torch.mean(torch.square(x32), dim=-1, keepdim=True)) + eps)


def _rms_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    rstd = _rstd(x32, eps)
    return (x32 * rstd * weight.to(torch.float32)).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """The reference's custom VJP: the cotangents leave in the boundary
    dtypes (bf16 in, bf16 out), never as f32 x-sized tensors."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        x32, dy32, w32 = x.to(torch.float32), dy.to(torch.float32), weight.to(torch.float32)
        rstd = _rstd(x32, ctx.eps)
        xhat = x32 * rstd
        # dL/dw: reduce over all leading dims
        dw = torch.sum(dy32 * xhat, dim=tuple(range(dy.ndim - 1))) if dy.ndim > 1 else dy32 * xhat
        # dL/dx = rstd * (g - xhat * mean(g * xhat)) with g = dy * w
        g = dy32 * w32
        dx = rstd * (g - xhat * reduce_partial(torch.mean(g * xhat, dim=-1, keepdim=True)))
        return dx.to(x.dtype), dw.to(weight.dtype), None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: f32 inside, ``x.dtype`` out; differentiable by the
    reference's hand-written VJP (the plain forward when nothing needs a
    gradient, as in serving)."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    return _rms_fwd(x, weight, eps)


def rope(positions: torch.Tensor, dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding at ``positions`` (..., seq)."""
    dev = positions.device
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim))
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., seq, dim/2)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate head vectors. x: (..., seq, heads, head_dim); cos/sin (..., seq, hd/2)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (V, D) at ``tokens`` → (*tokens.shape, D).

    On a ``DTensor`` table (a mesh) the lookup is vocab-parallel, whatever
    DTensor's own rules for indexing: each rank looks the tokens up in its
    own rows of the table in a ``local_map`` region (a token outside its
    vocab slice gives a zero row), and the mesh dims that shard the vocab
    sum the slices' rows, reduce-scattered onto the embed dim.  A rank
    never holds more than its own shard of the table (DTensor's
    ``aten.index`` replicates a vocab-sharded table under some torch
    versions).  Each row is one table row plus zeros, so the result is the
    unmeshed lookup's bits, but for a stored -0.0, which comes back +0.0.
    """
    if not is_dtensor(table):
        return table[tokens.long()]
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = table.device_mesh
    place = list(table.placements)
    with unset_fake_temporarily():  # the mesh's coordinates are real tensors
        (rows, _), (first, _) = compute_local_shape_and_global_offset(tuple(table.shape), mesh, place)
    edim = tokens.ndim

    def block(tab: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
        i = tok.long() - first
        ok = (i >= 0) & (i < rows)
        return torch.where(ok[..., None], tab[torch.where(ok, i, 0)], 0)

    partial = [Partial() if p.is_shard(0) else Shard(edim) if p.is_shard(1) else p for p in place]
    x = local_region(block, mesh, (place, [Replicate()] * mesh.ndim), partial)(table, as_dtensor(tokens, mesh))
    return x.redistribute(mesh, [Shard(edim) if p.is_shard(0) else q for p, q in zip(place, partial)])


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits (fp32 for a stable softmax/CE); on a mesh the
    sequence gathered first (``merge_ready``), the vocab sharded as the
    table's."""
    return torch.matmul(merge_ready(x).to(torch.float32), table.to(torch.float32).t())
