"""Sharding on a device mesh — port of ``repro/distributed``: the logical
activation axes and ``constrain`` (``context``), and the parameter, batch
and cache rules (``sharding``)."""
from repro_torch.distributed import sharding

__all__ = ["sharding"]
