"""Shared kernel plumbing: launch counts, wrapper checks, the drop-scatter,
the extent table.

Nothing of the reference's ``GridPlan`` or its (8, 128) padding carries over:
a CUDA kernel masks its own ragged edge.  What every kernel wrapper shares:

* a **launch count** per kernel, raised by one exactly where the wrapper
  launches its kernel (never on the plain CPU path), so a run can show that
  its main path went through the kernels;
* **checks** on device, dtype, shape and contiguity, raising on what a
  kernel does not take, and on the status the C entry point returns;
* :func:`put_drop_`, the plain-PyTorch form of JAX's ``.at[...].set(...,
  mode="drop")``, and :func:`scatter_levels_` built on it, shared by the
  plain versions and ``core.ggarray``;
* :func:`extent_table`, the device table through which the paged kernels
  (K8/K9, K10/K11, K12) address a pool of one or many extents — it replaces the
  reference's per-extent operands and ``kernels/common.py::extent_row``;
* :func:`device_buffer`, the per-device scratch and ticket buffers of the
  split decode kernels (K14, K10/K11), made once and grown, never inside a
  CUDA-graph capture, and :func:`sm_count`, from which their split counts
  and the paged gather's grid are sized;
* the plan of the append kernels' tile-parallel row scan (K3, K12;
  ``csrc/common.cuh``): :func:`scan_threads`, :func:`row_tiles`, and the
  Python twins of what its passes compute, :func:`tile_counts` and
  :func:`tile_ranks`.
"""
from __future__ import annotations

import functools
from collections import OrderedDict

import numpy as np
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
    "to_device",
    "copy_unit",
    "extent_table",
    "device_buffer",
    "sm_count",
    "put_drop_",
    "scatter_levels_",
    "SCAN_PER",
    "SCAN_THREADS",
    "scan_threads",
    "row_tiles",
    "tile_counts",
    "tile_ranks",
]

# Every CUDA kernel of the port, by the name its wrapper counts under.
KERNELS = (
    "row_scan", "push_back", "compact_blocks", "segmented_gather",
    "paged_gather", "paged_gather_extents", "slab_append",
    "flash_attention", "paged_attend", "paged_attend_extents", "push_back_multi",
    "row_scan_mxu", "dispatch", "combine", "decode_attention",
    # K15: every launch with the device counter plane on, whichever kernel
    "counter_plane",
)

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


def to_device(x, dev: torch.device) -> torch.Tensor:
    """A tensor on ``dev`` without a host sync.

    A tensor already on ``dev`` passes through; other data becomes a tensor
    as ``torch.as_tensor`` makes it.  Host data goes to a card with
    ``non_blocking=True``: from pageable memory ``cudaMemcpyAsync`` stages
    the bytes before it returns, so the source may go at once, and PyTorch
    does not synchronise the stream (a blocking copy would, which
    ``torch.cuda.set_sync_debug_mode`` reports).
    """
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if t.device == dev:
        return t
    # only host → card is safe without waiting: a copy to the host would be
    # read before it lands
    return t.to(dev, non_blocking=t.device.type == "cpu" and dev.type == "cuda")


def copy_unit(nbytes: int, *tensors: torch.Tensor) -> int:
    """The widest copy unit (16, 4, 2 or 1 bytes) dividing ``nbytes`` and
    the address of every tensor."""
    for unit in (16, 4, 2):
        if nbytes % unit == 0 and all(t.data_ptr() % unit == 0 for t in tensors):
            return unit
    return 1


# Extent tables by (device, extent pointers and sizes); a pool's table is
# built once per geometry, so an append or a gather copies nothing to the
# card unless the pool grew.  A served model holds two pools (k and v) per
# layer, each with its own table: 36 layers need 72 live entries.
_extent_tables: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_EXTENT_TABLES_KEPT = 1024


def extent_table(extents: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """The device int64 table ``[ptr_0 … ptr_{E-1}, start_0 … start_E]``.

    ``ptr_e`` is extent ``e``'s base address and ``start_e`` the global id
    of its first slab (``start_E`` = the slab count): the ``slab_tables``
    prefix.  A kernel resolves slab ``s`` by an upper-bound search over the
    starts — O(log E), and E is O(√n) under ``"tz"`` (about 700 extents at
    1.3·10⁵ slabs), too many for a fixed kernel parameter.  Built on the
    host and cached per geometry; rebuilt only when the pool grows.
    """
    dev = extents[0].device
    key = (str(dev),) + tuple((e.data_ptr(), e.shape[0]) for e in extents)
    table = _extent_tables.get(key)
    if table is not None:
        _extent_tables.move_to_end(key)
        return table
    starts = np.concatenate([[0], np.cumsum([e.shape[0] for e in extents])])
    host = np.concatenate([np.asarray([e.data_ptr() for e in extents], np.uint64).view(np.int64),
                           starts.astype(np.int64)])
    table = to_device(torch.from_numpy(host), dev)
    _extent_tables[key] = table
    while len(_extent_tables) > _EXTENT_TABLES_KEPT:
        _extent_tables.popitem(last=False)
    return table


def device_buffer(store: dict, retired: list, dev: torch.device, n: int, dtype: torch.dtype, *,
                  first: int, zero: bool, what: str) -> torch.Tensor:
    """``store[dev]``, at least ``n`` elements of ``dtype`` long: made at
    ``max(n, first)`` elements, then doubled (or grown to ``n``) when too
    short, zero-filled where ``zero``.  A buffer it replaces goes to
    ``retired`` and stays alive, because a captured CUDA graph may still
    launch with it.  Inside a CUDA-graph capture making or growing one
    raises (its zero fill would only be recorded, and the memory would
    belong to the graph's pool): one eager launch at the captured shape
    makes it first."""
    t = store.get(dev)
    if t is None or t.numel() < n:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{what}: the buffer must hold {n} elements before a CUDA-graph capture; launch "
                f"once eagerly at this shape first")
        if t is not None:
            retired.append(t)
        size = max(n, first, 2 * t.numel() if t is not None else 0)
        make = torch.zeros if zero else torch.empty
        t = store[dev] = make(size, dtype=dtype, device=dev)
    return t


@functools.cache
def sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
    vals = vals.expand((*lane_shape, *item)).reshape(nlanes, *item)
    # first valid lane, else 0; taken with index_select, since indexing by
    # a 0-d device tensor reads it on the host
    first = torch.argmax(valid.to(torch.int32)).reshape(1)
    any_valid = valid.index_select(0, first)[0]
    zero = torch.zeros((), dtype=torch.int64, device=dst.device)
    rep_idx = [torch.where(any_valid, i.index_select(0, first)[0], zero) for i in idx]
    rep_val = torch.where(any_valid, vals.index_select(0, first)[0], dst[(0,) * len(index)])
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


# The tile-parallel row scan of the append kernels (csrc/common.cuh): a row
# of m mask lanes is cut into tiles of threads * SCAN_PER lanes, SCAN_PER
# lanes a thread, and the grid is rows x tiles.
SCAN_PER = 16  # kScanPer
SCAN_THREADS = (64, 128, 256)  # the block sizes the kernels are built for


def scan_threads(m: int, work: int) -> int:
    """The block of an append kernel's scan pass: the fewest of
    :data:`SCAN_THREADS` that hold a row's ``m`` lanes at SCAN_PER a thread
    and ``work`` copy units (one a thread), at most 256.  So the Engine's
    decode append (m = 1, k and v of 512 bytes in 16-byte units: 64 units)
    is one block of 64 threads a row, and a wide wave 256."""
    need = min(max(-(-m // SCAN_PER), work), SCAN_THREADS[-1])
    return next(t for t in SCAN_THREADS if t >= need)


def row_tiles(m: int, threads: int) -> int:
    """Tiles a row of ``m`` lanes takes under blocks of ``threads``; where
    it is more than one, a count pass writes each tile's live count first."""
    return max(-(-m // (threads * SCAN_PER)), 1)


def tile_counts(mask: np.ndarray, threads: int) -> np.ndarray:
    """The count pass: ``mask`` (rows, m) → live lanes per tile, (rows, tiles)."""
    rows, m = mask.shape
    tiles = row_tiles(m, threads)
    padded = np.zeros((rows, tiles * threads * SCAN_PER), bool)
    padded[:, :m] = mask
    return padded.reshape(rows, tiles, -1).sum(2).astype(np.int64)


def tile_ranks(mask: np.ndarray, threads: int) -> tuple[np.ndarray, np.ndarray]:
    """The write pass's ranks, as its blocks compute them: thread t of a
    tile holds lanes t, t + threads, ..., t + 15·threads; row i of the tile
    gives each warp a ballot, warp 0 scans the (row, warp) counts in lane
    order from the sum of the row's earlier tile counts, and a lane adds
    the live lanes below it in its warp's ballot → (rank of every lane
    (rows, m), the row's exclusive tile prefix (rows, tiles + 1))."""
    rows, m = mask.shape
    counts = tile_counts(mask, threads)
    tiles = counts.shape[1]
    prefix = np.zeros((rows, tiles + 1), np.int64)
    np.cumsum(counts, 1, out=prefix[:, 1:])
    tl = threads * SCAN_PER
    padded = np.zeros((rows, tiles * tl), np.int64)
    padded[:, :m] = mask
    lanes = padded.reshape(rows, tiles, SCAN_PER, threads // 32, 32)  # (row, tile, i, warp, lane)
    warp_counts = lanes.sum(4).reshape(rows, tiles, -1)  # in (i, warp) order: lane order
    warp_first = (np.cumsum(warp_counts, 2) - warp_counts).reshape(lanes.shape[:4])
    below = np.cumsum(lanes, 4) - lanes
    ranks = prefix[:, :tiles, None, None, None] + warp_first[..., None] + below
    return ranks.reshape(rows, -1)[:, :m], prefix
