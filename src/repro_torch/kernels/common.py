"""Shared kernel plumbing: launch counts, wrapper checks, the drop-scatter.

Nothing of the reference's ``GridPlan`` or its (8, 128) padding carries over:
a CUDA kernel masks its own ragged edge.  What every kernel wrapper shares:

* a **launch count** per kernel, raised by one exactly where the wrapper
  launches its kernel (never on the plain CPU path), so a run can show that
  its main path went through the kernels;
* **checks** on device, dtype, shape and contiguity, raising on what a
  kernel does not take, and on the status the C entry point returns;
* :func:`put_drop_`, the plain-PyTorch form of JAX's ``.at[...].set(...,
  mode="drop")``, and :func:`scatter_levels_` built on it, shared by the
  plain versions and ``core.ggarray``.
"""
from __future__ import annotations

import torch

__all__ = [
    "KERNELS",
    "MEMORY_SPACES",
    "DISPATCH_METHODS",
    "count_launch",
    "launch_counts",
    "reset_launch_counts",
    "check_memory_space",
    "check_dispatch",
    "check_tensor",
    "check_status",
    "stream_of",
    "put_drop_",
    "scatter_levels_",
]

# Every CUDA kernel of the port, by the name its wrapper counts under.
KERNELS = ("row_scan", "push_back", "compact_blocks", "segmented_gather")

_launches = {name: 0 for name in KERNELS}

# TPU tilings and insert-permutation backends of the reference.  Accepted so
# signatures match; on the GPU every value gives the same kernel and output.
MEMORY_SPACES = ("vmem", "hbm")
DISPATCH_METHODS = ("auto", "onehot", "mxu")


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def check_memory_space(memory_space: str | None) -> None:
    """Validate the reference's TPU tiling knob (no effect on the GPU)."""
    if memory_space is not None and memory_space not in MEMORY_SPACES:
        raise ValueError(f"memory_space {memory_space!r} not in {MEMORY_SPACES}")


def check_dispatch(dispatch: str) -> None:
    """Validate the reference's insert-permutation knob (no effect on the GPU:
    the kernel scatters directly)."""
    if dispatch not in DISPATCH_METHODS:
        raise ValueError(f"dispatch {dispatch!r} not in {DISPATCH_METHODS}")


def check_tensor(
    t: torch.Tensor,
    what: str,
    *,
    device: torch.device,
    dtypes: tuple[torch.dtype, ...] | None = None,
    shape: tuple[int, ...] | None = None,
) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` of an accepted
    dtype and (where given) exactly ``shape``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def check_status(rc: int, lib, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        msg = lib.rt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: error {rc} ({msg})")


def stream_of(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the int a C entry point takes."""
    return torch.cuda.current_stream(device).cuda_stream


def put_drop_(
    dst: torch.Tensor,
    index: tuple[torch.Tensor, ...],
    valid: torch.Tensor,
    vals: torch.Tensor,
) -> torch.Tensor:
    """``dst[index] = vals`` for the lanes where ``valid``; other lanes write
    nothing.  In place, and with no host sync.

    JAX's ``mode="drop"`` sends a dropped lane to an out-of-range index;
    torch has no drop mode, and boolean indexing or ``nonzero`` would read
    the device.  So every dropped lane repeats the write of the first valid
    lane — the same index and the same bits, which makes the duplicate
    harmless — or, when no lane is valid, writes ``dst[0, ...]`` back onto
    itself.  ``index`` entries and ``valid`` broadcast to one lane shape;
    ``vals`` is that shape followed by the trailing dims of ``dst``.  Valid
    lanes must be in range and target distinct slots.
    """
    lane_shape = torch.broadcast_shapes(valid.shape, *(i.shape for i in index))
    nlanes = 1
    for d in lane_shape:
        nlanes *= d
    if nlanes == 0:
        return dst
    item = dst.shape[len(index):]
    valid = valid.expand(lane_shape).reshape(-1)
    idx = [i.expand(lane_shape).reshape(-1).to(torch.int64) for i in index]
    vals = vals.expand(*lane_shape, *item).reshape(nlanes, *item)
    first = torch.argmax(valid.to(torch.int32))  # first valid lane, else 0
    any_valid = valid[first]
    zero = torch.zeros((), dtype=torch.int64, device=dst.device)
    rep_idx = [torch.where(any_valid, i[first], zero) for i in idx]
    rep_val = torch.where(any_valid, vals[first], dst[(0,) * len(index)])
    lane_valid = valid.reshape((nlanes,) + (1,) * len(item))
    idx = [torch.where(valid, i, r) for i, r in zip(idx, rep_idx)]
    vals = torch.where(lane_valid, vals, rep_val)
    return dst.index_put_(tuple(idx), vals)


def scatter_levels_(
    levels: tuple[torch.Tensor, ...],  # level b: (nblocks, B0·2^b, *item)
    b0: int,
    pos: torch.Tensor,  # (nblocks, m) in-block target positions
    valid: torch.Tensor,  # (nblocks, m) bool
    elems: torch.Tensor,  # (nblocks, m, *item)
) -> None:
    """Scatter ``elems`` at in-block ``pos`` across the bucket levels, in
    place; lanes that are not valid or lie past the last level are dropped."""
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    for b, level in enumerate(levels):
        li = pos - b0 * ((1 << b) - 1)  # level b starts at B0 (2^b - 1)
        put_drop_(level, (rows, li), valid & (li >= 0) & (li < (b0 << b)), elems)
