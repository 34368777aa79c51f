"""Data pipelines on the two-phase runtime — port of ``repro.data``: the
token packer and step-indexed synthetic batches (``data/synthetic.py``)."""
from repro_torch.data.packing import Packer

__all__ = ["Packer"]
