"""K13 launcher: the CUDA flash-attention prefill kernel
(``csrc/flash_attention.cu``), replacing
``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.

The kernel takes (B, H, S, D) tensors by strides — any layout whose last
dimension is contiguous — so the model's (B, S, H, D) activations go in and
come out without a transpose copy.  The output is written in place.  bf16
and f16 run on the tensor cores and move rows by 16-byte asynchronous
copies, so there every base address and every batch, head and position
stride (of a dimension longer than 1) must be a multiple of 16 bytes: the
wrapper raises on a view that breaks it (every view the model makes is
aligned).  f32 runs on the CUDA cores and takes any such view.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common

__all__ = ["flash_attention_cuda", "HEAD_DIMS", "DTYPES"]

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _lib():
    lib = _build.library("flash_attention")
    lib.rt_flash_attention.argtypes = [
        _c, _c, _c, _c, ctypes.c_int,  # q, k, v, o, dtype
        _i64, _i64, _i64, _i64, _i64, _i64,  # B, H, group, Sq, Skv, D
        _c, ctypes.c_float, ctypes.c_int, _c,  # strides, scale, causal, stream
    ]
    lib.rt_flash_attention.restype = ctypes.c_int
    return lib


def flash_attention_cuda(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KH, Skv, D)
    v: torch.Tensor,  # (B, KH, Skv, D)
    out: torch.Tensor,  # (B, H, Sq, D), written in place
    *,
    group: int,
    causal: bool,
    sm_scale: float,
) -> torch.Tensor:
    """Launch K13 → ``out``.  Query head h reads KV head h // group."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda: tensors on {dev}, expected cuda")
    if q.ndim != 4:
        raise ValueError(f"flash_attention q: expected (B, H, Sq, D), got {tuple(q.shape)}")
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in {tuple(DTYPES)}")
    if H != KH * group:
        raise ValueError(f"flash_attention: {H} query heads != {KH} kv heads x group {group}")
    for name, t, shape in (("k", k, (B, KH, Skv, D)), ("v", v, (B, KH, Skv, D)),
                           ("out", out, (B, H, Sq, D))):
        if t.device != dev or t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(f"flash_attention {name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {q.dtype} {shape} on {dev}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention {name}: last dimension must be contiguous")
        if q.dtype != torch.float32 and (t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)):
            raise ValueError(f"flash_attention {name}: {q.dtype} needs a 16-byte-aligned base "
                             f"and batch/head/position strides (strides {t.stride()})")
    if B == 0 or Sq == 0:
        return out
    if Skv == 0:
        raise ValueError("flash_attention: no keys")
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPES[q.dtype],
            B, H, group, Sq, Skv, D, ctypes.cast(strides, _c), float(sm_scale), int(causal),
            common.stream_of(dev),
        )
    common.check_status(rc, lib, "flash_attention")
    common.count_launch("flash_attention")
    return out
