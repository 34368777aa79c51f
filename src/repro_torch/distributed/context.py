"""Activation-sharding context — port of ``repro/distributed/context.py``:
model code asks, the launcher decides.

Model modules call ``constrain(x, ("batch", "seq", None))`` with *logical*
axis names.  When a launcher has activated a mesh (``activation_mesh``) and
``x`` is a ``DTensor`` on it, the names resolve to mesh axes, each kept
only where the dim divides over it, and ``x`` is redistributed to that
layout: ``DTensor.redistribute`` is PyTorch's ``with_sharding_constraint``.
Without a mesh, or on a plain tensor (one card, or the local block of a
``local_map`` region), the call returns ``x`` unchanged, so the same model
code runs on one card and on a mesh.

Logical activation axes (the reference's table, verbatim):
  batch   → ('pod', 'data')                       (DP)
  seq     → 'model'                               (sequence parallelism)
  tokens  → ('pod', 'data', 'model')              (flattened B·S, MoE routing)
  experts → 'model'                               (EP)
  heads   → 'model'
  kv_seq  → 'model'                               (decode cache seq dim)
"""
from __future__ import annotations

import contextlib
import threading
from collections.abc import Mapping
from typing import Any

import torch

from repro_torch.tree import tree_map

__all__ = ["PartitionSpec", "activation_mesh", "constrain", "constrain_tree", "active_mesh", "mesh_axes",
           "placements", "redistribute", "logical_spec", "replicate_dims", "merge_ready", "merge_ready_grad",
           "reduce_partial", "is_dtensor", "LOGICAL_AXES",
           "local_region", "placed_zeros", "as_dtensor", "rank_index"]

LOGICAL_AXES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": "model",
    "tokens": ("pod", "data", "model"),
    "experts": "model",
    # flattened E·C dim, expert-major: E over 'model' (EP), capacity over the
    # data axes — one (expert-shard, capacity-shard) tile per device, so the
    # expert FFN intermediates scale down with the FULL mesh, not just EP.
    "expert_slots": ("model", "pod", "data"),
    "expert_cap": ("pod", "data"),
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "ssm_inner": "model",
    "kv_seq": "model",
    # logits vocab dim: sharding V over 'model' keeps the unembed backward's
    # per-device partial d(table) at (V/16, D) instead of a full (V, D) f32
    # partial per device (≈3 GB each on 150k vocabs; caught by the dry-run)
    "vocab": "model",
}

_STATE = threading.local()


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: one entry a tensor dim (a mesh axis, a
    tuple of axes, or None), written as JAX writes it (a one-axis tuple is
    that axis, an empty one None); a tuple the port's tree functions treat
    as a leaf, as JAX treats its ``PartitionSpec``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple):
                return None if not e else e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def active_mesh():
    """The mesh ``activation_mesh`` set on this thread, or None."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def activation_mesh(mesh):
    """Activate ``mesh`` (a ``DeviceMesh``) for constrain() calls within the
    block.  The outermost activation also lets plain tensors (rope tables,
    masks) mix with ``DTensor``s as replicated, and runs the backward on
    the calling thread: both settings, like the mesh, are the thread's own,
    and a card's backward would otherwise run on autograd's device thread
    (where a remat recompute would find no mesh)."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = active_mesh()
    _STATE.mesh = mesh
    try:
        if mesh is None or prev is not None:
            yield
        else:
            with implicit_replication(), torch.autograd.set_multithreading_enabled(False):
                yield
    finally:
        _STATE.mesh = prev


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name → size, in mesh order: of a ``DeviceMesh``, of a mapping, or
    of anything with a ``shape`` mapping (a shape-only mesh)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _axis_size(shape: dict, axis) -> int:
    if axis is None:
        return 1
    axes = axis if isinstance(axis, tuple) else (axis,)
    out = 1
    for a in axes:
        if a not in shape:
            return 0  # axis absent on this mesh → cannot shard
        out *= shape[a]
    return out


def placements(spec, mesh) -> list:
    """A spec (one entry per tensor dim: a mesh axis, a tuple of axes or
    None) → one ``Shard(d)`` or ``Replicate()`` per mesh dim.  A tuple
    shards its tensor dim over several mesh dims, the first axis major, as
    JAX does; DTensor splits a dim over mesh dims in mesh order, so a
    tuple must list its axes in that order.  A mesh dim of size 1 holds the
    whole dim whatever the spec says: it is ``Replicate()`` (DTensor cannot
    reshape a dim sharded even over one rank)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    names = list(sizes)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r}: axes out of mesh order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return out


def redistribute(x, spec, mesh):
    """A ``DTensor`` laid out as ``spec`` says on ``mesh`` (itself when it is)."""
    target = placements(spec, mesh)
    if tuple(target) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def constrain_tree(tree, specs_tree):
    """Redistribute every ``DTensor`` leaf of ``tree`` to its spec in
    ``specs_tree``; the identity without an active mesh, without specs, and
    on plain tensors.  Pins gradients and accumulators to the parameter
    layout."""
    mesh = active_mesh()
    if mesh is None or specs_tree is None:
        return tree
    return tree_map(lambda x, spec: redistribute(x, spec, mesh) if is_dtensor(x) else x,
                    tree, specs_tree)


def logical_spec(shape: tuple, axes: tuple, mesh) -> PartitionSpec:
    """Logical names → a spec for a tensor of ``shape`` on ``mesh``: each
    name's mesh axes (those present), kept where the dim divides."""
    sizes = mesh_axes(mesh)
    spec = []
    for dim, name in zip(shape, axes):
        mesh_axis = LOGICAL_AXES.get(name) if name else None
        if isinstance(mesh_axis, tuple):
            mesh_axis = tuple(a for a in mesh_axis if a in sizes) or None
        size = _axis_size(sizes, mesh_axis)
        spec.append(mesh_axis if mesh_axis and size > 0 and dim % size == 0 else None)
    return PartitionSpec(*spec, *(None,) * (len(shape) - len(spec)))


def replicate_dims(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """A ``DTensor`` redistributed so that no mesh dim shards tensor dims
    ``dims`` (the rest of its layout kept); a plain tensor unchanged.  For
    the ops DTensor cannot run on a sharded dim (``PERF.md`` lists them)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dims = {d % x.ndim for d in dims}
    target = [Replicate() if getattr(p, "dim", None) in dims else p for p in x.placements]
    return x if target == list(x.placements) else x.redistribute(x.device_mesh, target)


def merge_ready(x: torch.Tensor, start: int = 0, end: int | None = None) -> torch.Tensor:
    """``x`` laid out so that a view may merge its dims ``start`` to
    ``end`` (exclusive; all but the last by default) into one: of those
    longer than 1, only the first stays sharded, the later ones are
    gathered.  ``torch.matmul`` and ``torch.einsum`` fold their operands'
    leading dims so; merging a sharded dim into the one before it rests on
    one torch version's DTensor rule (2.13 flattens it through a strided
    shard, 2.11 refuses).  A plain tensor unchanged."""
    if not is_dtensor(x):
        return x
    live = [d for d in range(start, x.ndim - 1 if end is None else end) if x.shape[d] > 1]
    return replicate_dims(x, *live[1:])


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` whose pending sums (``Partial`` placements: a sum or a
    mean over a sharded dim) are reduced now, the rest of its layout kept;
    anything else unchanged.  Left pending, the next op's sharding rule
    decides where they are reduced, and torch versions decide differently
    (2.13 reduce-scattered a norm's row statistics onto the sequence, 2.11
    all-reduced them)."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p for p in x.placements])


class _MergeReadyGrad(torch.autograd.Function):
    """The identity, whose backward hands on ``merge_ready(gradient)``."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return merge_ready(g)


def merge_ready_grad(y: torch.Tensor) -> torch.Tensor:
    """``y``, whose gradient is made ``merge_ready`` before it reaches the
    op that made ``y``: the output of a product, whose backward folds the
    gradient's leading dims as the forward folded its input's, while the
    gradient arrives in the residual stream's layout (the sequence
    sharded).  A plain tensor unchanged."""
    return _MergeReadyGrad.apply(y) if is_dtensor(y) and y.requires_grad else y


def constrain(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """Redistribute a ``DTensor`` by logical names; the identity without a
    mesh and on a plain tensor."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return redistribute(x, logical_spec(tuple(x.shape), axes, mesh), mesh)


class _RanksFrom(torch.autograd.Function):
    """The identity on a region's local tensor, whose backward sets
    ``kernels.common.STEP.ranks`` to ``ranks``: a region's outputs set its
    rank count where the gradient enters the region, its inputs the count
    outside where the gradient leaves, so a step counter counts the
    region's backward ops as it counts its forward ones."""

    @staticmethod
    def forward(ctx, x, ranks):
        ctx.ranks = ranks
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.common import STEP

        STEP.ranks = ctx.ranks
        return g, None


def local_region(fn, mesh, in_placements, out_placements, in_grad_placements=None):
    """``local_map(fn)`` on ``mesh`` — PyTorch's ``shard_map``: ``DTensor``
    arguments are redistributed to ``in_placements`` and ``fn`` runs on
    each rank's local tensors; its outputs come back as ``DTensor``s laid
    out as ``out_placements`` (``()`` for a region that only writes its
    arguments in place).  While ``fn`` runs, and while its backward runs,
    ``kernels.common.STEP.ranks`` is the mesh's rank count: a step counter
    counts each op of the region that many times."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels.common import STEP

    def marked(t, ranks):
        if isinstance(t, torch.Tensor) and t.requires_grad and torch.is_grad_enabled():
            return _RanksFrom.apply(t, ranks)
        return t

    def body(*args):
        prev, STEP.ranks = STEP.ranks, mesh.size()
        try:
            out = fn(*(marked(a, prev) for a in args))
            return tuple(marked(o, mesh.size()) for o in out) if isinstance(out, tuple) else marked(
                out, mesh.size())
        finally:
            STEP.ranks = prev

    return local_map(body, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)


def rank_index(mesh, dims) -> int:
    """This rank's index among the ranks of mesh dims ``dims`` taken
    together, the first major (0 for no dims): which slice it holds of a
    tensor dim those mesh dims shard."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():  # the mesh's coordinates are real tensors
        coord = mesh.get_coordinate()
    idx = 0
    for d in dims:
        idx = idx * mesh.size(d) + coord[d]
    return idx


def placed_zeros(shape: tuple, dtype: torch.dtype, device, mesh, spec) -> torch.Tensor:
    """A zero ``DTensor`` of global ``shape`` laid out as ``spec`` on
    ``mesh``, each rank allocating its own shard only."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    place = placements(spec, mesh)
    with unset_fake_temporarily():  # the mesh's coordinates are real tensors
        local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh, place)
    stride, n = [], 1
    for d in reversed(shape):  # contiguous
        stride.insert(0, n)
        n *= d
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), mesh, place,
                              run_check=False, shape=torch.Size(shape), stride=tuple(stride))


def as_dtensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as a ``DTensor`` on ``mesh``: itself if it is one, else
    replicated (every rank holds the same plain tensor)."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
