"""Optimisers — port of ``repro/optim``: AdamW, the LR schedule and
gradient compression with error feedback."""
from repro_torch.optim import adamw, compression, schedule

__all__ = ["adamw", "schedule", "compression"]
