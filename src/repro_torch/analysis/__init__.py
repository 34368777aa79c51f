"""Step cost analysis — port of ``repro/analysis``: the dispatch-level
FLOP / traffic / collective counter (``flops``) and the roofline terms
(``roofline``)."""
from repro_torch.analysis import roofline

__all__ = ["roofline"]
