"""Sharding rules: parameter name → logical axes → mesh spec — port of
``repro/distributed/sharding.py``.

A spec is a ``PartitionSpec``: a tuple with one entry per tensor dim (a
mesh axis, a tuple of axes, or None), or empty for a replicated leaf,
exactly as the reference writes them; ``context.placements`` turns one into
``DTensor`` placements on a ``DeviceMesh``.  The rules read only the mesh's
axis names and sizes (``context.mesh_axes``), so they also take a
shape-only mesh.

Scheme (DESIGN.md §5):
- **TP** over ``'model'``: d_ff, experts, padded vocab, attention heads
  *when divisible* (else head_dim when divisible, else replicated).
- **FSDP** over ``'data'``: the d_model dim of every weight, which also
  shards the AdamW moments (ZeRO).
- **DP** over ``('pod', 'data')`` for the batch dim of activations.
- Decode KV caches shard batch over ``'data'`` and the *sequence* dim over
  ``'model'``.
- Anything 1-D (norms, biases, scalars) is replicated.

Rules attach to the *last* ndims of each leaf so period-stacked layer
params (leading ``n_periods`` dim) reuse the per-layer rule unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import (PartitionSpec, active_mesh, is_dtensor, mesh_axes,
                                             placements, redistribute)
from repro_torch.tree import map_with_keys, tree_map

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "placements",
    "logical_rules",
    "param_specs",
    "param_shardings",
    "constrain_param_tree",
    "cache_specs",
    "batch_specs",
    "data_axes",
    "shard_if_divisible",
]


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` — the reference's ``NamedSharding``; a leaf
    of the port's trees.  ``placements`` gives its ``DTensor`` layout."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes carrying data parallelism: ('pod', 'data') on multi-pod meshes."""
    shape = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _axis_size(mesh, axis) -> int:
    shape = mesh_axes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= shape[a]
        return out
    return shape[axis]


def shard_if_divisible(mesh, dim_size: int, axis) -> Any:
    """axis if dim divides over it, else None (replicate)."""
    return axis if axis is not None and dim_size % _axis_size(mesh, axis) == 0 else None


def logical_rules(cfg: ModelConfig, mesh) -> dict[str, Any]:
    """Logical axis name → mesh axis (or None), with divisibility fallbacks."""
    shape = mesh_axes(mesh)
    model = "model" if "model" in shape else None
    fsdp = "data" if "data" in shape else None
    msize = _axis_size(mesh, model)
    heads_ok = model and cfg.n_heads % msize == 0
    kv_ok = model and cfg.n_kv_heads % msize == 0
    hd_ok = model and cfg.head_dim % msize == 0
    rules: dict[str, Any] = {
        "embed": shard_if_divisible(mesh, cfg.d_model, fsdp),
        "vocab": shard_if_divisible(mesh, cfg.padded_vocab, model),
        "ff": shard_if_divisible(mesh, cfg.d_ff, model) if cfg.d_ff else None,
        "heads": model if heads_ok else None,
        "head_dim": model if (not heads_ok and hd_ok) else None,
        "kv_heads": model if kv_ok else None,
        "kv_head_dim": model if (not kv_ok and hd_ok) else None,
        "experts": None,
        "ff_expert": None,
        "ssm_inner": None,
    }
    if cfg.moe is not None:
        rules["experts"] = shard_if_divisible(mesh, cfg.moe.n_experts, model)
        if rules["experts"] is None:  # fall back to TP inside each expert
            rules["ff_expert"] = shard_if_divisible(mesh, cfg.moe.d_ff_expert, model)
    if cfg.ssm is not None:
        rules["ssm_inner"] = shard_if_divisible(mesh, cfg.ssm.d_inner(cfg.d_model), model)
    return rules


# parameter name → logical axes of its *trailing* dims
_NAME_AXES: dict[str, tuple[str | None, ...]] = {
    "embed": ("vocab", "embed"),
    "unembed": ("vocab", "embed"),
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "kv_head_dim"),
    "wv": ("embed", "kv_heads", "kv_head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "w_gate": ("embed", "ff"),
    "w_up": ("embed", "ff"),
    "w_down": ("ff", "embed"),
    "router": ("embed", None),
    "wz": ("embed", "ssm_inner"),
    "wx": ("embed", "ssm_inner"),
    "wBC": ("embed", None),
    "wdt": ("embed", None),
    "out_proj": ("ssm_inner", "embed"),
}
# MoE expert tensors carry a leading experts dim
_MOE_NAME_AXES: dict[str, tuple[str | None, ...]] = {
    "w_gate": ("experts", "embed", "ff_expert"),
    "w_up": ("experts", "embed", "ff_expert"),
    "w_down": ("experts", "ff_expert", "embed"),
}


def _leaf_spec(keys: tuple, leaf, rules) -> PartitionSpec:
    name = keys[-1] if keys else ""
    in_moe = "moe" in keys
    axes = (_MOE_NAME_AXES if in_moe and name in _MOE_NAME_AXES else _NAME_AXES).get(name)
    if axes is None or leaf.ndim < len(axes):
        return P()  # norms, biases, scalars, conv — replicated
    mesh_axes_ = tuple(rules.get(a) if a else None for a in axes)
    pad = (None,) * (leaf.ndim - len(mesh_axes_))  # period-stacked leading dims
    return P(*pad, *mesh_axes_)


def param_specs(params, cfg: ModelConfig, mesh):
    """Spec tree matching ``params`` (also fits the AdamW moments and EF)."""
    rules = logical_rules(cfg, mesh)
    return map_with_keys(lambda keys, leaf: _leaf_spec(keys, leaf, rules), params)


def constrain_param_tree(tree, cfg: ModelConfig):
    """Redistribute a (sub)tree of parameters to its rule layout under the
    active mesh; the identity without one and on plain tensors.  Called on
    each period's sliced layer params, as the reference calls it inside the
    period-scan body."""
    mesh = active_mesh()
    if mesh is None:
        return tree
    rules = logical_rules(cfg, mesh)
    return map_with_keys(lambda keys, leaf: redistribute(leaf, _leaf_spec(keys, leaf, rules), mesh)
                         if is_dtensor(leaf) else leaf, tree)


def param_shardings(params, cfg: ModelConfig, mesh):
    """A tree of ``NamedSharding`` matching ``params``: each leaf's spec on
    ``mesh`` (``.placements``: one ``Shard(d)`` or ``Replicate()`` a mesh dim)."""
    return tree_map(lambda _, spec: NamedSharding(mesh, spec), params,
                    param_specs(params, cfg, mesh))


def cache_specs(caches_like, cfg: ModelConfig, mesh):
    """Decode-cache specs: batch→data, seq→model (flash-decode layout),
    mamba heads/channels→model — each with divisibility fallback."""
    dp = data_axes(mesh)
    model = "model" if "model" in mesh_axes(mesh) else None

    def spec(keys, leaf) -> PartitionSpec:
        name = keys[-1] if keys else ""
        b_axis = dp if dp and leaf.shape[1] % _axis_size(mesh, dp) == 0 else None
        if name == "conv":  # (P, B, W, CH)
            ch = shard_if_divisible(mesh, leaf.shape[-1], model)
            return P(None, b_axis, None, ch)
        if name == "ssd":  # (P, B, NH, HD, N)
            nh = shard_if_divisible(mesh, leaf.shape[2], model)
            return P(None, b_axis, nh, None, None)
        # k/v levels (P, B, L, KH, Dh) and their scale tensors (P, B, L, KH)
        seq = shard_if_divisible(mesh, leaf.shape[2], model)
        return P(*((None, b_axis, seq) + (None,) * (leaf.ndim - 3)))

    return map_with_keys(spec, caches_like)


def batch_specs(cfg: ModelConfig, mesh, batch_size: int) -> dict[str, PartitionSpec]:
    """Input batch specs: batch dim over ('pod','data') when divisible."""
    dp = data_axes(mesh)
    b_axis = dp if dp and batch_size % _axis_size(mesh, dp) == 0 else None
    out = {"tokens": P(b_axis, None)}
    if cfg.n_enc_layers:
        out["frames"] = P(b_axis, None, None)
    elif cfg.n_prefix_embeds:
        out["prefix_embeds"] = P(b_axis, None, None)
    return out
