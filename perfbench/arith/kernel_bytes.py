"""Bytes and operations each measured kernel needs, counted once per input
byte read and once per output byte written, whatever the kernel reads
again (the kernel bounds of ``chip_smoke.py``, rewritten here)."""
from __future__ import annotations

from perfbench.arith import peaks


def push_back_bound_s(nblocks: int, m: int, live: int, item_bytes: int) -> float:
    """K3, one fused push-back wave of ``nblocks × m`` lanes, ``live`` of
    them masked in: each lane's mask byte and payload read and its int32
    position written, the block sizes read and written (int32 each), and
    the live payload written into the levels.  One integer operation a lane
    (the in-block scan) on the CUDA cores."""
    lanes = nblocks * m
    nbytes = lanes * (1 + item_bytes + 4) + 8 * nblocks + item_bytes * live
    return peaks.bound_s(nbytes, ops=lanes)

