"""Token sampling: greedy / temperature — port of ``repro/serving/sampler.py``.

Greedy is exact (argmax, as the reference).  Temperature sampling draws from
a ``torch.Generator``: JAX's PRNG does not carry over, so sampled streams
differ between the packages by design.  Neither reads the device.
"""
from __future__ import annotations

import torch

__all__ = ["sample"]


def sample(gen: torch.Generator | None, logits: torch.Tensor,
           temperature: float = 0.0) -> torch.Tensor:
    """logits (B, V) → tokens (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
