"""Kernel crossover thresholds — port of ``repro.kernels.tuning``.

``"auto"`` push-back routing keeps the reference's threshold so the two
packages route every wave the same way.  The value 32 was measured for the
TPU kernels in Pallas interpret mode; it is unmeasured on the H100 (the
sweep that sets it for the card is queued in ROADMAP.md).
"""
from __future__ import annotations

__all__ = ["FUSED_PUSH_BACK_MIN_WAVE", "resolve_push_back_method"]

# Smallest per-block wave width m routed to the fused push-back kernel.
FUSED_PUSH_BACK_MIN_WAVE = 32


def resolve_push_back_method(method: str, m: int) -> str:
    """Resolve ``method="auto"`` for an ``m``-lane push-back wave.

    Explicit methods pass through untouched; ``"auto"`` picks the fused
    kernel at or above :data:`FUSED_PUSH_BACK_MIN_WAVE` lanes and the plain
    scan+scatter path below it.
    """
    if method != "auto":
        return method
    return "fused" if m >= FUSED_PUSH_BACK_MIN_WAVE else "scan"
