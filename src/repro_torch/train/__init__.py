"""Training — port of ``repro/train``: the loss and the train step
(``step``) and the fault-tolerant loop (``loop``)."""
from repro_torch.train import step

__all__ = ["step"]
