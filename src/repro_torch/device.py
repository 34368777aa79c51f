"""Device resolution for the port's entry points.

``device=None`` means the card.  There is no quiet fallback to the CPU: a
caller that wants the CPU (the tests, a laptop) passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve"]


def resolve(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` → ``cuda`` (raises if there is no CUDA device); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
