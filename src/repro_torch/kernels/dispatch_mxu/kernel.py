"""K5a/K5b launchers: the CUDA scatter-add dispatch and the gather combine
(``csrc/dispatch.cu``).

K5a replaces ``repro/kernels/dispatch_mxu/kernel.py::dispatch_pallas`` and
K5b ``::combine_pallas``: the reference's one-hot matrix products become a
scatter and a row gather.  K5a stores each live element with a plain store
and marks its slot in an occupancy bitmap, then zero-fills the unmarked
slots; a slot marked twice (fewer bits set than marks made) sends the
launch down the collision path, where the
scatter is done again as a zero fill plus ``atomicAdd`` (the path for
repeated positions, chosen on the device: ``csrc/dispatch.cu`` has the
design).  The header (the two counts) and the bitmap are one
scratch buffer per device (``common.device_buffer``), cleared by the
launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common

__all__ = ["dispatch_cuda", "combine_cuda", "DISPATCH_DTYPES", "scratch_words", "dispatch_path",
           "dispatch_atomic_cuda"]

DISPATCH_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
SCRATCH0 = 1 << 16  # the scratch buffer's first size, in 32-bit words

_scratch: dict = {}
_retired: list = []

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _lib():
    lib = _build.library("dispatch")
    lib.rt_dispatch.argtypes = [_c, _c, _c, _c, ctypes.c_int, _i64, _i64, _i64, _c]
    lib.rt_dispatch.restype = ctypes.c_int
    lib.rt_dispatch_atomic.argtypes = [_c, _c, _c, ctypes.c_int, _i64, _i64, _i64, _c]
    lib.rt_dispatch_atomic.restype = ctypes.c_int
    lib.rt_combine.argtypes = [_c, _c, _c, _i64, _i64, _i64, ctypes.c_int, _c]
    lib.rt_combine.restype = ctypes.c_int
    return lib


def _check_pos(pos: torch.Tensor, n: int, dev: torch.device, what: str) -> None:
    common.check_tensor(pos, f"{what} pos", device=dev, dtypes=(torch.int32,), shape=(n,))


SCRATCH_HEADER = 4  # 32-bit words: two 64-bit counts, the marks made and the bits found set


def scratch_words(n_slots: int) -> int:
    """32-bit words of K5a's scratch for ``n_slots`` slots: the header,
    then one occupancy bit a slot."""
    return SCRATCH_HEADER + -(-n_slots // 32)


def _checked(x: torch.Tensor, pos: torch.Tensor, n_slots: int, what: str) -> torch.Tensor:
    """K5a's argument checks → its output buffer, ``(n_slots, D)`` uninitialised."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: tensors on {dev}, expected cuda")
    common.check_tensor(x, "dispatch x", device=dev, dtypes=tuple(DISPATCH_DTYPES))
    if x.ndim != 2:
        raise ValueError(f"dispatch x: expected (T, D), got {tuple(x.shape)}")
    _check_pos(pos, x.shape[0], dev, "dispatch")
    if not 0 <= n_slots < 2**31:
        raise ValueError(f"dispatch: n_slots {n_slots} outside [0, 2^31)")
    return torch.empty((n_slots, x.shape[1]), dtype=x.dtype, device=dev)


def dispatch_cuda(x: torch.Tensor, pos: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Launch K5a: ``x (T, D)``, int32 ``pos (T,)`` → ``(n_slots, D)``.

    Every launch on a device shares that device's scratch (the counts and
    the occupancy bitmap), so launches on one device must be ordered on
    one stream: two that overlap on two streams clear each other's marks,
    and the fill pass would then zero live slots."""
    out = _checked(x, pos, n_slots, "dispatch_cuda")
    T, D = x.shape
    if n_slots * D == 0:
        return out
    dev = x.device
    lib = _lib()
    scratch = common.device_buffer(_scratch, _retired, dev, scratch_words(n_slots), torch.int32,
                                   first=SCRATCH0, zero=False, what="dispatch scratch")
    with torch.cuda.device(dev):
        rc = lib.rt_dispatch(x.data_ptr(), pos.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                             DISPATCH_DTYPES[x.dtype], T, D, n_slots, common.stream_of(dev))
    common.check_status(rc, lib, "dispatch")
    common.count_launch("dispatch")
    return out


def dispatch_path(dev: torch.device) -> str | None:
    """The path K5a's last launch on ``dev`` took: ``"store"`` (unique
    positions) or ``"atomic"`` (a slot marked twice); None before any
    launch.  Reads the scratch's header, so it waits for the launch."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    scratch = _scratch.get(dev)
    if scratch is None:
        return None
    marks, bits = scratch[:SCRATCH_HEADER].cpu().view(torch.int64).tolist()
    return "atomic" if marks != bits else "store"


def dispatch_atomic_cuda(x: torch.Tensor, pos: torch.Tensor, n_slots: int) -> torch.Tensor:
    """K5a's design before its redesign, alone: a zero fill of the output,
    then ``atomicAdd`` over all of ``x``.  A yardstick that
    ``chip_smoke.py`` times beside K5a; no path of the port calls it, and
    it counts no launch."""
    out = _checked(x, pos, n_slots, "dispatch_atomic_cuda")
    T, D = x.shape
    if n_slots * D == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.rt_dispatch_atomic(x.data_ptr(), pos.data_ptr(), out.data_ptr(),
                                    DISPATCH_DTYPES[x.dtype], T, D, n_slots, common.stream_of(x.device))
    common.check_status(rc, lib, "dispatch_atomic")
    return out


def combine_cuda(buf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Launch K5b: ``buf (S, *item)``, int32 ``pos (T,)`` → ``(T, *item)``."""
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"combine_cuda: tensors on {dev}, expected cuda")
    common.check_tensor(buf, "combine buf", device=dev)
    if buf.ndim < 1 or buf.shape[0] < 1:
        raise ValueError(f"combine buf: expected (S >= 1, ...), got {tuple(buf.shape)}")
    T = pos.shape[0] if pos.ndim == 1 else -1
    _check_pos(pos, T, dev, "combine")
    out = torch.empty((T, *buf.shape[1:]), dtype=buf.dtype, device=dev)
    row_bytes = buf[0].numel() * buf.element_size()
    if T * row_bytes == 0:
        return out
    lib = _lib()
    unit = next(u for u in (16, 8, 4, 2, 1)
                if row_bytes % u == 0 and buf.data_ptr() % u == 0 and out.data_ptr() % u == 0)
    with torch.cuda.device(dev):
        rc = lib.rt_combine(buf.data_ptr(), pos.data_ptr(), out.data_ptr(), T, row_bytes,
                            buf.shape[0], unit, common.stream_of(dev))
    common.check_status(rc, lib, "combine")
    common.count_launch("combine")
    return out
