"""Carry a GGArray's or an arena's state between the JAX reference and the
port, as numpy.

``ggarray_from_numpy`` builds the port's :class:`GGArray` from the
reference's leaves given as numpy arrays (``np.asarray`` of each bucket
level and of ``sizes``); ``ggarray_to_numpy`` goes back.
``arena_from_numpy`` / ``arena_to_numpy`` do the same for a
:class:`~repro_torch.pool.SlabArena`, as a dict of numpy arrays (see
:data:`ARENA_KEYS`), and ``cache_from_numpy`` / ``cache_to_numpy`` for a KV
cache slot (static, frozen, ggarray or paged: a dict of arrays, a paged
pool possibly a tuple of extents).  ``params_from_numpy`` turns the reference's model
parameter tree (layers stacked along the period axis) into the port's,
which has the same structure, so both packages compute the same function.
numpy has no
bfloat16 of its own: ``np.asarray`` of a JAX bf16 array gives an
``ml_dtypes`` bfloat16 array, which torch does not take, so bf16 travels as
its ``uint16`` bit pattern — accepted on the way in (by dtype name) and
returned on the way out.  ``train_state_from_numpy`` /
``train_state_to_numpy`` carry a whole training state (parameters, AdamW
step and moments, the error-feedback residual) leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.ggarray import GGArray

__all__ = [
    "ARENA_KEYS",
    "arena_from_numpy",
    "arena_to_numpy",
    "cache_from_numpy",
    "cache_to_numpy",
    "ggarray_from_numpy",
    "ggarray_to_numpy",
    "params_from_numpy",
    "tensor_from_numpy",
    "tensor_to_numpy",
    "train_state_from_numpy",
    "train_state_to_numpy",
]

# An arena's state as numpy: the extents' data (a list, bf16 as uint16
# bits), the device free bitmap, the page tables and sizes, and the host
# allocator's owner, refcount and free arrays.
ARENA_KEYS = ("extents", "free", "pages", "sizes", "owner", "refcount", "alloc_free")


def tensor_from_numpy(arr: np.ndarray, device: "str | torch.device | None" = None) -> torch.Tensor:
    """numpy → a new tensor on ``device`` (always a copy: the port writes
    levels in place); an ml_dtypes bfloat16 array becomes torch.bfloat16."""
    arr = np.array(arr)
    dev = _device.resolve(device)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor → numpy; torch.bfloat16 comes back as its uint16 bit pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def ggarray_from_numpy(
    buckets: Sequence[np.ndarray],
    sizes: np.ndarray,
    b0: int,
    device: "str | torch.device | None" = None,
) -> GGArray:
    """The port's GGArray from the reference's leaves (levels and sizes) as numpy."""
    levels = tuple(tensor_from_numpy(b, device) for b in buckets)
    return GGArray(
        buckets=levels,
        sizes=tensor_from_numpy(np.asarray(sizes, np.int32), device),
        b0=b0,
    )


def ggarray_to_numpy(arr: GGArray) -> tuple[tuple[np.ndarray, ...], np.ndarray, int]:
    """→ (levels as numpy, sizes as int32 numpy, b0); bf16 levels as uint16 bits."""
    return (
        tuple(tensor_to_numpy(b) for b in arr.buckets),
        tensor_to_numpy(arr.sizes).astype(np.int32),
        arr.b0,
    )


def arena_to_numpy(arena: Any) -> dict:
    """A port ``SlabArena``'s state as numpy, keyed by :data:`ARENA_KEYS`."""
    return {
        "extents": [tensor_to_numpy(e) for e in arena.pool.extents],
        "free": tensor_to_numpy(arena.pool.free),
        "pages": tensor_to_numpy(arena.arr.pages).astype(np.int32),
        "sizes": tensor_to_numpy(arena.arr.sizes).astype(np.int32),
        "owner": np.array(arena.alloc.owner, np.int32),
        "refcount": np.array(arena.alloc.refcount, np.int32),
        "alloc_free": np.array(arena.alloc.free, bool),
    }


def arena_from_numpy(
    state: dict,
    *,
    device: "str | torch.device | None" = None,
    live_ub: "np.ndarray | None" = None,
    **arena_kwargs: Any,
) -> Any:
    """A port ``SlabArena`` holding ``state`` (keys :data:`ARENA_KEYS`, e.g.
    the reference arena's leaves as numpy).

    ``arena_kwargs`` are the constructor's (``grow_chunk``, ``quota_slabs``,
    …); ``dtype`` and the geometry come from the extents.  The host book is
    rebuilt from the page tables: each array's pages in table order, the
    slab→page map, the table width.  ``live_ub`` seeds the planner's bounds
    (default: the sizes, exact after host-known masks).  Counters that only
    the history knows (claims, releases, which slabs were ever released)
    start at zero.
    """
    from repro_torch.pool.arena import ArenaGGArray, SlabArena
    from repro_torch.pool.extents import ExtentPool

    extents = tuple(tensor_from_numpy(e, device) for e in state["extents"])
    pages = np.asarray(state["pages"], np.int32)
    narrays, max_pages = pages.shape
    slab_size, item = extents[0].shape[1], tuple(extents[0].shape[2:])
    arena = SlabArena(narrays, slab_size, item_shape=item, dtype=extents[0].dtype,
                      initial_slabs=0, max_pages=max_pages, device=device, **arena_kwargs)
    dev = arena.device
    arena.pool = ExtentPool(extents=extents,
                            free=tensor_from_numpy(np.asarray(state["free"], bool), dev))
    sizes = np.asarray(state["sizes"], np.int32)
    arena.arr = ArenaGGArray(pages=tensor_from_numpy(pages, dev),
                             sizes=tensor_from_numpy(sizes, dev))
    n_slabs = sum(e.shape[0] for e in state["extents"])
    book = arena.book
    book.grow(n_slabs)
    book.max_pages = max_pages
    book.alloc.free = np.array(state["alloc_free"], bool)
    book.alloc.owner = np.array(state["owner"], np.int32)
    book.alloc.refcount = np.array(state["refcount"], np.int32)
    book.alloc.grown_slabs = n_slabs
    book.alloc.peak_live = book.alloc.live_count
    for i in range(narrays):
        row = [int(s) for s in pages[i] if s >= 0]
        book.pages_of[i] = row
        book.npages[i] = len(row)
        book.page_of_slab[row] = np.arange(len(row))
    arena.planner.ub = np.asarray(sizes if live_ub is None else live_ub, np.int64).copy()
    return arena


# Leaves the reference keeps in f32 whatever ``param_dtype`` says:
# ``repro/models/moe.py:61`` and ``repro/models/ssm.py:54-56``.
_F32_LEAVES = {("moe", "router"), ("mamba", "A_log"), ("mamba", "D"), ("mamba", "dt_bias")}


def _distribute(tree: Any, specs: Any, mesh: Any) -> Any:
    """Each leaf (the whole array, the same on every rank) as a ``DTensor``
    laid out by its spec on ``mesh``; each rank keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.context import placements
    from repro_torch.tree import tree_map

    return tree_map(lambda t, spec: distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None),
                    tree, specs)


def params_from_numpy(cfg: Any, tree: Any, device: "str | torch.device | None" = None, *,
                      mesh: Any = None) -> Any:
    """The reference's parameter tree as numpy → the port's, on ``device``.

    ``tree`` is ``jax.tree.map(np.asarray, params)`` of the reference's
    ``transformer.init_params``: ``{"embed", "final_norm", "layers": [slot
    dicts with leaves stacked over n_periods], ("unembed"), ("encoder")}``.  The port
    keeps that structure leaf for leaf.  bf16 leaves may come as ml_dtypes
    bfloat16 or as their ``uint16`` bits.  Every leaf must have the dtype
    the reference gives it: ``cfg.param_dtype``, except the MoE router and
    the SSM's ``A_log``, ``D`` and ``dt_bias``, which are f32 in any model
    (``_F32_LEAVES``).  With ``mesh`` (every rank passing the same arrays)
    the leaves are ``DTensor``s laid out by ``sharding.param_specs``.
    """
    from repro_torch.models.transformer import DTYPES, check_supported

    check_supported(cfg)

    def leaf(path: str, arr) -> torch.Tensor:
        parent, name = path.split("/")[-2:]
        want = torch.float32 if (parent, name) in _F32_LEAVES else DTYPES[cfg.param_dtype]
        arr = np.asarray(arr)
        if arr.dtype == np.uint16 and want == torch.bfloat16:
            t = tensor_from_numpy(arr.view(np.int16), device).view(torch.bfloat16)
        else:
            t = tensor_from_numpy(arr, device)
        if t.dtype != want:
            raise TypeError(f"params_from_numpy: {path} is {t.dtype}, the reference's is {want}")
        return t

    def walk(path: str, node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(f"{path}/{k}", v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(f"{path}/{i}", v) for i, v in enumerate(node)]
        return leaf(path, node)

    out = walk("", tree)
    for i, slot in enumerate(out["layers"]):
        if slot["norm1"].shape[0] != cfg.n_periods:
            raise ValueError(f"params_from_numpy: layers/{i} holds {slot['norm1'].shape[0]} "
                             f"periods, config says {cfg.n_periods}")
    if mesh is not None:
        from repro_torch.distributed.sharding import param_specs

        out = _distribute(out, param_specs(out, cfg, mesh), mesh)
    return out


def cache_from_numpy(cache: dict, device: "str | torch.device | None" = None, *,
                     cfg: Any = None, mesh: Any = None) -> dict:
    """A reference KV cache slot, its leaves as numpy (``np.asarray`` of each;
    a paged pool may be a tuple of extents) → the port's slot on ``device``.
    bf16 leaves may come as ml_dtypes bfloat16 or as ``uint16`` bits.  With
    ``cfg`` and ``mesh`` (a period-stacked slot, the same arrays on every
    rank) the leaves are ``DTensor``s placed by ``sharding.cache_specs``."""
    def leaf(arr) -> torch.Tensor:
        arr = np.asarray(arr)
        if arr.dtype == np.uint16:
            return tensor_from_numpy(arr.view(np.int16), device).view(torch.bfloat16)
        return tensor_from_numpy(arr, device)

    out = {k: tuple(leaf(e) for e in v) if isinstance(v, (tuple, list)) else leaf(v)
           for k, v in cache.items()}
    if mesh is not None:
        from repro_torch.distributed.sharding import cache_specs

        out = _distribute(out, cache_specs(out, cfg, mesh), mesh)
    return out


def cache_to_numpy(cache: dict) -> dict:
    """A port KV cache slot → numpy leaves (bf16 as ``uint16`` bits)."""
    return {k: tuple(tensor_to_numpy(e) for e in v) if isinstance(v, tuple) else tensor_to_numpy(v)
            for k, v in cache.items()}


def train_state_from_numpy(cfg: Any, state: Any, device: "str | torch.device | None" = None) -> Any:
    """The reference's ``TrainState`` with numpy leaves (``jax.tree.map(
    np.asarray, state)``) → the port's on ``device``: the parameters by
    ``params_from_numpy`` (requiring grad), the step, the f32 moments and
    the residual (``state.ef`` may be None) as they are."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.compression import EFState
    from repro_torch.train.step import TrainState
    from repro_torch.tree import leaves, tree_map

    params = params_from_numpy(cfg, state.params, device)
    for p in leaves(params):
        p.requires_grad_(True)

    def f32(arr) -> torch.Tensor:
        return tensor_from_numpy(np.asarray(arr), device)

    opt = AdamWState(step=f32(state.opt.step), m=tree_map(f32, state.opt.m),
                     v=tree_map(f32, state.opt.v))
    ef = None if state.ef is None else EFState(residual=tree_map(f32, state.ef.residual))
    return TrainState(params=params, opt=opt, ef=ef)


def train_state_to_numpy(state: Any) -> Any:
    """The port's ``TrainState`` → the same structure with numpy leaves
    (bf16 as ``uint16`` bits)."""
    from repro_torch.tree import tree_map

    return tree_map(tensor_to_numpy, state)
