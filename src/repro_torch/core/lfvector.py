"""Single LFVector — the per-block unit of GGArray (paper Algs. 1–2), port of
``repro.core.lfvector``.

A one-block view that mirrors the paper's pseudocode directly.  ``GGArray``
is not built on it (it vectorises over blocks natively); this keeps the
Algorithm 1/2 semantics testable on their own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core import ggarray as gg_ops
from repro_torch.core.ggarray import GGArray
from repro_torch.kernels.common import to_device

__all__ = ["LFVector"]


@dataclasses.dataclass
class LFVector:
    """One LFVector: geometric buckets + a size counter (host-side wrapper)."""

    _gg: GGArray
    _planner: gg_ops.CapacityPlanner = dataclasses.field(default_factory=gg_ops.CapacityPlanner)

    @classmethod
    def create(
        cls,
        b0: int = 8,
        item_shape: Sequence[int] = (),
        dtype: torch.dtype = torch.float32,
        *,
        device: "str | torch.device | None" = None,
    ) -> "LFVector":
        """Empty vector; ``device=None`` means the card, ``"cpu"`` the CPU."""
        return cls(gg_ops.init(1, b0, item_shape, dtype, device=device))

    # -- paper Alg. 1: push_back -----------------------------------------
    def push_back(self, elems: Any, method: str = "scan") -> torch.Tensor:
        """Insert a batch of elements; grows (Alg. 2) if needed → their indices.

        The amortised protocol: planner-reserved capacity + in-place append,
        so steady-state pushes read nothing from the device.
        """
        elems = torch.atleast_1d(to_device(elems, self._gg.device))
        self._gg = self._planner.reserve(self._gg, elems.shape[0])
        self._gg, pos, headroom = gg_ops.append(self._gg, elems[None], method=method)
        self._planner.note_append(self._gg, headroom)
        return pos[0]

    # -- element access ----------------------------------------------------
    def __getitem__(self, idx) -> torch.Tensor:
        idx = to_device(idx, self._gg.device)
        return gg_ops.gather_block(self._gg, torch.zeros_like(idx), idx)

    def __setitem__(self, idx, val) -> None:
        self._gg = gg_ops.write_global(self._gg, idx, val)

    def __len__(self) -> int:
        return int(self._gg.sizes[0].item())

    # -- introspection ------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._gg.capacity_per_block

    @property
    def nbuckets(self) -> int:
        return self._gg.nbuckets

    def to_array(self) -> torch.Tensor:
        flat, _ = gg_ops.flatten(self._gg)
        return flat[: len(self)]
