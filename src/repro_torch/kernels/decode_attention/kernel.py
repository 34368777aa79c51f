"""K14 launcher: flash-decode over a contiguous KV cache
(``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention/kernel.py::decode_attention_pallas``.
K and V are read through their strides (the last one 1), so the op's
head-major (B, KH, S, D) and the static cache's token-major (B, S, KH, D),
viewed as (B, KH, S, D), both go in without a copy.  One launch per call:
each (sequence, head) is split into :func:`num_splits` blocks over its live
keys, and the last block of each merges them.  The blocks take tickets from
an int32 counter per (sequence, head) that the kernel leaves at 0; the
counters live here, one buffer per device, zeroed once and grown with
B·KH, so launches on one device must run in stream order.  The buffer
cannot be made or grown inside a CUDA-graph capture (its zero fill would
only be recorded): a launch that would do so raises, and one eager launch
at the captured B·KH, or :func:`tickets`, before the capture makes it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common

__all__ = ["decode_attention_cuda", "num_splits", "DTYPES", "HEAD_DIMS", "MAX_GROUP",
           "MAX_SPLITS", "SPLIT_KEYS", "TICKETS0"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16
MAX_SPLITS = 128  # the kernel's merge holds this many states (kMaxSplits)
SPLIT_KEYS = 32  # no more splits than one per this many cache positions
TICKETS0 = 64  # the counter buffer's first size, in (sequence, head) pairs

_c = ctypes.c_void_p
_i64 = ctypes.c_int64
_tickets: dict[torch.device, torch.Tensor] = {}
# buffers replaced by a larger one stay alive: a captured CUDA graph may
# still launch with them
_retired: list[torch.Tensor] = []


def _lib():
    lib = _build.library("decode_attention")
    lib.rt_decode_attention.argtypes = [
        _c, _c, _c, _c,  # q, k, v, lengths
        _c, _c, _c, _c, _c, ctypes.c_int,  # scratch m, l, acc, tickets, out, dtype
        _i64, _i64, _i64, _i64, _i64, _i64,  # B, KH, G, D, S, nsplit
        _i64, _i64, _i64, _i64, _i64, _i64,  # k strides, v strides (batch, head, token)
        ctypes.c_float, _c,  # scale, stream
    ]
    lib.rt_decode_attention.restype = ctypes.c_int
    lib.rt_decode_max_splits.argtypes = []
    lib.rt_decode_max_splits.restype = ctypes.c_int
    if lib.rt_decode_max_splits() != MAX_SPLITS:
        raise RuntimeError("decode_attention: the library's split limit differs from MAX_SPLITS")
    return lib


def num_splits(S: int, bkh: int, sms: int) -> int:
    """Blocks per (sequence, head): about two a SM over the ``bkh`` pairs,
    at most one per ``SPLIT_KEYS`` cache positions and ``MAX_SPLITS``.
    From shapes alone — the live lengths are never read on the host."""
    return max(1, min(-(-2 * sms // max(bkh, 1)), -(-S // SPLIT_KEYS), MAX_SPLITS))


def tickets(dev: torch.device, n: int) -> torch.Tensor:
    """The device's counter buffer, at least ``n`` int32 zeros long."""
    return common.device_buffer(_tickets, _retired, dev, n, torch.int32, first=TICKETS0, zero=True,
                                what="decode_attention tickets")


def decode_attention_cuda(
    q: torch.Tensor,  # (B, KH, G, D) contiguous
    k: torch.Tensor,  # (B, KH, S, D), strided, last stride 1
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32
    *,
    sm_scale: float,
) -> torch.Tensor:
    """Launch K14 → (B, KH, G, D) in ``q.dtype``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda: tensors on {dev}, expected cuda")
    common.check_tensor(q, "decode_attention q", device=dev, dtypes=tuple(DTYPES))
    if q.ndim != 4:
        raise ValueError(f"decode_attention q: expected (B, KH, G, D), got {tuple(q.shape)}")
    B, KH, G, D = q.shape
    S = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"decode_attention: group {G} not in 1..{MAX_GROUP}")
    if q.data_ptr() % 16:
        raise ValueError("decode_attention q: must be 16-byte aligned")
    esize = q.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype or tuple(t.shape) != (B, KH, S, D):
            raise ValueError(f"decode_attention {name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {q.dtype} {(B, KH, S, D)} on {dev}")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(s * esize % 16 for s in t.stride()[:3]):
            raise ValueError(f"decode_attention {name}: rows must be contiguous and 16-byte aligned")
    common.check_tensor(lengths, "decode_attention lengths", device=dev,
                        dtypes=(torch.int32,), shape=(B,))
    if B == 0:
        return torch.empty_like(q)
    tix = tickets(dev, B * KH)
    out = torch.empty_like(q)
    lib = _lib()
    nsplit = num_splits(S, B * KH, common.sm_count(dev))
    n = B * KH * nsplit * G
    # the states' acc first: the merge reads it 16 bytes at a time
    part = torch.empty((D + 2) * n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.rt_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            part[D * n:].data_ptr(), part[(D + 1) * n:].data_ptr(), part.data_ptr(),
            tix.data_ptr(), out.data_ptr(), DTYPES[q.dtype], B, KH, G, D, S, nsplit,
            *k.stride()[:3], *v.stride()[:3], float(sm_scale), common.stream_of(dev),
        )
    common.check_status(rc, lib, "decode_attention")
    common.count_launch("decode_attention")
    return out
