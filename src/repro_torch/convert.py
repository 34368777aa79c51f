"""Carry a GGArray's state between the JAX reference and the port, as numpy.

``ggarray_from_numpy`` builds the port's :class:`GGArray` from the
reference's leaves given as numpy arrays (``np.asarray`` of each bucket
level and of ``sizes``); ``ggarray_to_numpy`` goes back.  numpy has no
bfloat16 of its own: ``np.asarray`` of a JAX bf16 array gives an
``ml_dtypes`` bfloat16 array, which torch does not take, so bf16 travels as
its ``uint16`` bit pattern — accepted on the way in (by dtype name) and
returned on the way out.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.ggarray import GGArray

__all__ = ["ggarray_from_numpy", "ggarray_to_numpy", "tensor_from_numpy", "tensor_to_numpy"]


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
