"""K14 launcher: flash-decode over a contiguous KV cache
(``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention/kernel.py::decode_attention_pallas``.
K and V are read through their strides (the last one 1), so the op's
head-major (B, KH, S, D) and the static cache's token-major (B, S, KH, D),
viewed as (B, KH, S, D), both go in without a copy.  Two launches per call
(segments, merge), counted as one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common

__all__ = ["decode_attention_cuda", "DTYPES", "HEAD_DIMS", "MAX_GROUP"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _lib():
    lib = _build.library("decode_attention")
    lib.rt_decode_attention.argtypes = [
        _c, _c, _c, _c, _c, _c, _c, _c, ctypes.c_int,  # q, k, v, lengths, scratch x3, out, dtype
        _i64, _i64, _i64, _i64, _i64,  # B, KH, G, D, S
        _i64, _i64, _i64, _i64, _i64, _i64,  # k strides, v strides (batch, head, token)
        ctypes.c_float, _c,  # scale, stream
    ]
    lib.rt_decode_attention.restype = ctypes.c_int
    lib.rt_decode_segments.argtypes = [_i64]
    lib.rt_decode_segments.restype = _i64
    return lib


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
    esize = q.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype or tuple(t.shape) != (B, KH, S, D):
            raise ValueError(f"decode_attention {name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {q.dtype} {(B, KH, S, D)} on {dev}")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(s * esize % 16 for s in t.stride()[:3]):
            raise ValueError(f"decode_attention {name}: rows must be contiguous and 16-byte aligned")
    common.check_tensor(lengths, "decode_attention lengths", device=dev,
                        dtypes=(torch.int32,), shape=(B,))
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    nseg = lib.rt_decode_segments(S)
    part = torch.empty((2 + D) * B * KH * nseg * G, dtype=torch.float32, device=dev)
    n = B * KH * nseg * G
    with torch.cuda.device(dev):
        rc = lib.rt_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            part.data_ptr(), part[n:].data_ptr(), part[2 * n:].data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, KH, G, D, S, *k.stride()[:3], *v.stride()[:3],
            float(sm_scale), common.stream_of(dev),
        )
    common.check_status(rc, lib, "decode_attention")
    common.count_launch("decode_attention")
    return out
