"""Median over the window's jobs of the insert phase: CUDA events before
the first and after the last ``append`` of a job."""


def read(rec):
    return rec.insert_ms
