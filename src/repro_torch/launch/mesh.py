"""Mesh construction — port of ``repro/launch/mesh.py``.

Functions, not module constants: importing this module touches no device
and no process group.  Both build a ``DeviceMesh`` over the ranks of the
process group the caller has initialised (``torch.distributed.
init_process_group``), one rank a device.  Single pod: 16×16 = 256 ranks
('data', 'model'); multi-pod: 2×16×16 = 512 ranks ('pod', 'data', 'model').
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve

__all__ = ["make_production_mesh", "make_host_mesh"]


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve(device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialised process group of "
            f"{math.prod(shape)} ranks (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"a {shape} mesh needs {math.prod(shape)} ranks; the process group has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: "str | torch.device | None" = None):
    """(16, 16) ('data', 'model'), or (2, 16, 16) ('pod', 'data', 'model')."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, device: "str | torch.device | None" = None):
    """A small ('data', 'model') mesh over the process group's ranks (tests,
    one card).  Its device type is the card's unless ``device="cpu"``."""
    return _mesh((data, model), ("data", "model"), device)
