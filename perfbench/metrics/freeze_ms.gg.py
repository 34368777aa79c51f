"""Median over the window's jobs of ``freeze()``, between CUDA events."""


def read(rec):
    return rec.freeze_ms
