"""Checkpointing: atomic per-array save, async writer, restore — port of
``repro/checkpoint/ckpt.py``, in the reference's on-disk format.

``<dir>/step_<N:08d>/`` holds a ``manifest.json`` (per-leaf key, file,
shape and dtype, plus user metadata) and one ``.npy`` per leaf, with the
reference's keys in its order (``tree.paths``: dict keys sorted, NamedTuple
fields as ``.name``), so the two packages read each other's f32
checkpoints.  Writes go to ``step_<N>.tmp`` renamed into place, so a crash
mid-save never leaves a partial checkpoint that ``latest_step`` would pick.

numpy has no bfloat16: a bf16 leaf is written as its uint16 bits with
``"dtype": "bfloat16"`` in the manifest.  On restore, a 2-byte leaf whose
manifest says bfloat16 becomes ``torch.bfloat16`` — the port's ``<u2``
files and the reference's, which ``np.save`` writes as ``|V2`` (and which
the reference cannot restore itself).

The port updates parameters and moments in place, so ``save_async``
copies the tree to host memory before it returns (the reference copies in
its thread, which is safe only because JAX arrays are immutable); the
thread then only writes files.

The format is shard-agnostic: a ``DTensor`` leaf is saved whole
(``full_tensor``), and ``restore(..., shardings=...)`` places each leaf for
the *restoring* mesh, whatever mesh wrote it — the reference's elastic
reshard.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.context import is_dtensor
from repro_torch.tree import leaves, paths, unflatten

__all__ = ["save", "save_async", "restore", "latest_step", "wait_pending"]

_PENDING: list[threading.Thread] = []


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf → (a numpy copy that owns its memory, the manifest dtype)."""
    leaf = leaf.detach()
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    t = leaf.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _snapshot(tree) -> list[tuple[str, np.ndarray, str]]:
    return [(key, *_to_host(leaf)) for key, leaf in paths(tree)]


def _write(ckpt_dir: str, step: int, snap, metadata: dict | None) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    entries = []
    for i, (key, arr, dtype) in enumerate(snap):
        fname = f"{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        entries.append({"key": key, "file": fname, "shape": list(arr.shape), "dtype": dtype})
    manifest = {"step": step, "leaves": entries, "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _meshed(tree) -> bool:
    """A tree with ``DTensor`` leaves: every rank gathers it, rank 0 writes."""
    return any(is_dtensor(leaf) for leaf in leaves(tree))


def save(ckpt_dir: str, step: int, tree, *, metadata: dict | None = None) -> str:
    """Blocking atomic save → the final directory's path.  On a mesh every
    rank calls it; rank 0 writes and the ranks meet after the write."""
    snap = _snapshot(tree)
    if not _meshed(tree):
        return _write(ckpt_dir, step, snap, metadata)
    if dist.get_rank() == 0:
        _write(ckpt_dir, step, snap, metadata)
    dist.barrier()
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save_async(ckpt_dir: str, step: int, tree, *, metadata: dict | None = None) -> threading.Thread:
    """Copy the tree to host now, write it on a worker thread (on a mesh,
    only rank 0's thread writes)."""
    snap = _snapshot(tree)
    write = not _meshed(tree) or dist.get_rank() == 0
    t = threading.Thread(target=_write if write else lambda *_: None,
                         args=(ckpt_dir, step, snap, metadata), daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending() -> None:
    while _PENDING:
        _PENDING.pop().join()


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step with a complete manifest (ignores ``.tmp`` partials)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, dtype: str, like: torch.Tensor, sharding=None) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if dtype == "bfloat16" and arr.dtype.itemsize == 2:  # <u2 (the port) or |V2 (the reference)
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if sharding is not None:
        from torch.distributed.tensor import distribute_tensor

        # every rank read the whole leaf: each keeps its shard, no exchange
        t = distribute_tensor(t.to(sharding.mesh.device_type), sharding.mesh,
                              sharding.placements, src_data_rank=None)
    else:
        t = t.to(like.device)
    if like.requires_grad:
        t.requires_grad_(True)
    return t


def restore(ckpt_dir: str, step: int, tree_like, *, shardings=None):
    """Load step ``step`` into the structure of ``tree_like`` → (tree,
    metadata).  Each leaf is a new tensor on its ``tree_like`` leaf's
    device, requiring grad where that leaf does; with ``shardings`` (a
    matching tree of ``distributed.sharding.NamedSharding``, as
    ``param_shardings`` gives) a ``DTensor`` placed for that mesh."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like = leaves(tree_like)
    if len(manifest["leaves"]) != len(like):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"structure expects {len(like)}"
        )
    shard = [None] * len(like) if shardings is None else leaves(shardings)
    restored = [_from_host(np.load(os.path.join(d, e["file"])), e["dtype"], l, s)
                for e, l, s in zip(manifest["leaves"], like, shard)]
    return unflatten(tree_like, restored), manifest["metadata"]
