"""Token packing on the two-phase runtime — port of ``repro.data.packing``.

Variable-length documents are pushed into per-block sequence buffers owned
by a :class:`repro_torch.runtime.TwoPhasePipeline`; when a training batch is
due, ``pack`` freezes the pipeline — the segmented flatten emits the packed
token stream — then thaws it so ingestion can continue.  Block-local
insertion means parallel workers pack without coordination, and the
freeze-time prefix table gives global sample offsets for boundary masks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import ggarray as gg
from repro_torch.kernels import common
from repro_torch.runtime import TwoPhasePipeline

__all__ = ["Packer"]


@dataclasses.dataclass
class Packer:
    """Greedy block-local document packer over a two-phase token buffer.

    ``backend="pipeline"`` (default) owns per-block GGArray buckets;
    ``backend="arena"`` runs the same lifecycle over a shared slab pool
    (``repro_torch.pool.SlabArena``, one logical array per block).  Both give
    identical packs.  ``device=None`` means the card.
    """

    nblocks: int = 8
    b0: int = 256
    flatten_impl: str = "segmented"
    backend: str = "pipeline"
    device: "str | torch.device | None" = None

    def __post_init__(self):
        dev = self._dev = _device.resolve(self.device)
        if self.backend == "arena":
            from repro_torch.pool import SlabArena

            self._pipe = TwoPhasePipeline.from_arena(
                SlabArena(self.nblocks, self.b0, dtype=torch.int32, device=dev)
            )
        elif self.backend == "pipeline":
            self._pipe = TwoPhasePipeline(
                self.nblocks, self.b0, dtype=torch.int32, flatten_impl=self.flatten_impl,
                device=dev,
            )
        else:
            raise ValueError(f"unknown Packer backend {self.backend!r}")
        self._bounds = gg.init(self.nblocks, max(self.b0 // 16, 1), dtype=torch.int32, device=dev)
        # host mirrors of the per-block token/boundary counts: the packer
        # builds every mask itself, so greedy balancing and capacity
        # planning need no device read per document
        self._sizes_host = np.zeros((self.nblocks,), np.int64)
        self._nbounds_host = np.zeros((self.nblocks,), np.int64)

    @property
    def total_tokens(self) -> int:
        return self._pipe.total_size()

    @property
    def sizes(self) -> torch.Tensor:
        """Per-block token counts (the greedy-balance load vector)."""
        return self._pipe.sizes

    @property
    def stats(self):
        """Freeze/grow lifecycle counters of the underlying pipeline."""
        return self._pipe.stats

    def add_document(self, tokens: "list[int] | np.ndarray") -> None:
        """Push one document into the least-loaded block (greedy balance).

        Fully host-planned: the block and the boundary positions come from
        the host-side size mirror and the masks stay numpy, so ingestion
        makes zero planner reads of the device per document.
        """
        toks = np.asarray(tokens, np.int32)
        block = int(np.argmin(self._sizes_host))
        elems = np.zeros((self.nblocks, len(toks)), np.int32)
        mask = np.zeros((self.nblocks, len(toks)), bool)
        elems[block] = toks
        mask[block] = True
        # the mask stays a host array: the planner advances the target
        # block's bound by len(toks) and every other block's by 0
        self._pipe.append(common.to_device(elems, self._dev), mask)
        # record the document end position (per-block boundary list); the
        # host mirror gives the exact max, so reserve never reads the device
        self._bounds = gg.reserve(self._bounds, 1, max_size=int(self._nbounds_host.max()))
        bval = np.zeros((self.nblocks, 1), np.int32)
        bmask = np.zeros((self.nblocks, 1), bool)
        bval[block] = int(self._sizes_host[block]) + len(toks)
        bmask[block] = True
        self._bounds, _, _ = gg.append(
            self._bounds, common.to_device(bval, self._dev), common.to_device(bmask, self._dev)
        )
        self._sizes_host[block] += len(toks)
        self._nbounds_host[block] += 1

    def pack(self, batch: int, seq: int, pad_id: int = 0) -> dict:
        """Freeze → (batch, seq) token matrix + loss mask → thaw (resume grow)."""
        frozen = self._pipe.freeze()
        n = int(frozen.size.item())
        need = batch * seq
        stream = np.full((need,), pad_id, np.int32)
        take = min(n, need)
        stream[:take] = frozen.data[:take].cpu().numpy()
        self._pipe.thaw()  # zero-copy: the storage is intact
        tokens = stream.reshape(batch, seq)
        mask = (np.arange(need) < take).reshape(batch, seq)
        return {"tokens": torch.from_numpy(tokens).to(self._dev),
                "loss_mask": torch.from_numpy(mask).to(self._dev)}
