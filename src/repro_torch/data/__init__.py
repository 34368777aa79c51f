"""Data pipelines on the two-phase runtime — port of ``repro.data``
(so far the token packer; ``synthetic.py`` needs the model configs)."""
from repro_torch.data.packing import Packer

__all__ = ["Packer"]
