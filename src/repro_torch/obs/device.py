"""Device counter plane (K15) — in-kernel counters drained without host
syncs — port of ``repro/obs/device.py``.

Each instrumented CUDA kernel (K3 push-back, K7 segmented gather, K8/K9
paged gather, K10/K11 paged decode attention) takes one extra pointer: a
``(NSLOTS,)`` int32 **counter block** on the card, zeroed by the wrapper (a
memset on the stream) and added to by the kernel through
``csrc/common.cuh::ctr_accum`` — one ``atomicAdd`` per slot per thread
block, after the block has reduced its threads' contributions.  A null
pointer means off, and the kernels are compiled as ``template <bool
kCount>``, so an uninstrumented launch runs the same code as a kernel
without the plane.  The block replaces the reference's ``(8, 128)`` int32
VMEM tile (``CTR_ROWS × CTR_LANES``, row 0 holding the slots): the GPU has
no tiling to respect, so ``ctr_shape``/``ctr_block_spec`` have no meaning
here and are not ported.  :func:`from_block` turns a block into the
fixed-layout float32 vector (:data:`SLOTS`), which the ops wrappers return
and the serving steps sum as ordinary device data.

Four slots count the TPU's tiling in the reference, and here count the
card's own lanes instead — a deliberate difference, since a kernel that
pads nothing has no padding waste to report:

* ``push_back.lanes`` = ``nblocks·m`` (the reference pads rows to 8 and
  lanes to 128) and ``push_back.padded_lanes`` = 0;
* ``slab_append.lanes`` = ``N·m`` (the reference pads lanes to 128);
* ``paged_gather.masked_tiles`` = ``N·P − live`` (the reference's vmem
  tiling also counts its padded rows; its ``memory_space="hbm"`` count is
  this one).

Totals are float32, as in the reference: a slot rounds above 2^24.

Nothing here reads a device value.  :func:`pack` builds a vector without
a host round trip: the Python numbers go up once per device and value set
(a cached non-blocking copy), the device scalars are added on the card.
:class:`DeviceCounterPlane` holds vectors (``add`` is a list append),
``flush`` hands one 0-d slice per slot to ``Counter.add_lazy``, and the
numbers only materialise at the registry's drain points
(``counters()``/``snapshot()``).  Collection in the serving steps goes
through a :func:`tape`: the cache ops :func:`record` their vectors and the
step returns the tape's total when ``cfg.instrument`` is set.  PyTorch
traces nothing, but the steps still open one scope per step.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict

import numpy as np
import torch

__all__ = [
    "SLOTS",
    "NSLOTS",
    "SLOT_INDEX",
    "new_block",
    "zeros",
    "pack",
    "from_block",
    "as_dict",
    "Tape",
    "tape",
    "record",
    "recording",
    "DeviceCounterPlane",
]

# One entry per counter, fixed layout: entry i of a counter block is
# SLOTS[i] (csrc/common.cuh's CtrSlot enum keeps the same order).  Grouped
# by kernel family; the names double as registry counter names under the
# "device." prefix.
SLOTS: tuple[str, ...] = (
    # push_back: fused bucket append (kernels/push_back)
    "push_back.waves",          # kernel launches (one wave each)
    "push_back.lanes",          # wave lanes processed (nblocks × m)
    "push_back.active_lanes",   # Σ mask — lanes that carried an element
    "push_back.padded_lanes",   # lanes added by padding (none on the card)
    "push_back.level_writes",   # bucket-level slots written across all levels
    # paged gather: page-table walk (kernels/paged)
    "paged_gather.launches",
    "paged_gather.tiles",       # page tiles with a live slab id (copied work)
    "paged_gather.masked_tiles",  # −1 / out-of-pool page entries walked (waste)
    # paged attend: flash-decode page walk (kernels/paged)
    "paged_attend.launches",
    "paged_attend.tiles",         # KV tiles entering the online softmax
    "paged_attend.tiles_skipped",  # page steps gated off (tail slabs, −1)
    "paged_attend.lanes",         # score lanes in visited tiles
    "paged_attend.masked_lanes",  # score lanes past kv_len in visited tiles
    # flatten: segmented gather (kernels/flatten)
    "flatten.launches",
    "flatten.rows_touched",     # block rows visited by the gather
    "flatten.span_rows",        # Σ (ends − starts) — the information bound
    # slab append: arena wave insert (kernels/paged.slab_append)
    "slab_append.waves",
    "slab_append.lanes",
    "slab_append.active_lanes",
)
NSLOTS = len(SLOTS)
SLOT_INDEX: dict[str, int] = {name: i for i, name in enumerate(SLOTS)}


def new_block(device: "torch.device | str") -> torch.Tensor:
    """A zeroed ``(NSLOTS,)`` int32 counter block for one instrumented
    launch (a memset on the current stream, no host sync)."""
    return torch.zeros((NSLOTS,), dtype=torch.int32, device=device)


def zeros(device: "torch.device | str") -> torch.Tensor:
    return torch.zeros((NSLOTS,), dtype=torch.float32, device=device)


# Host parts of pack(), uploaded once per (device, values): a steady step
# packs the same Python numbers every time and copies nothing.
_static: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_STATIC_KEPT = 256


def _upload(key: tuple, host: np.ndarray, device: torch.device) -> torch.Tensor:
    t = _static.get(key)
    if t is not None:
        _static.move_to_end(key)
        return t
    t = torch.from_numpy(host)
    if device.type != "cpu":
        # non_blocking: pageable memory is staged before the call returns,
        # and PyTorch does not synchronise (kernels.common.to_device)
        t = t.to(device, non_blocking=True)
    _static[key] = t
    while len(_static) > _STATIC_KEPT:
        _static.popitem(last=False)
    return t


def pack(device: "torch.device | str | None" = None, **slots) -> torch.Tensor:
    """A counter vector from named slot values (device scalars or Python
    numbers); unnamed slots are zero.  Dotted names go through a dict:
    ``pack(dev, **{"push_back.waves": 1})``.  ``device`` defaults to the
    device of the first tensor value, else the CPU.

    Python numbers form a host vector, uploaded once per device and value
    set; tensors (0-d or one element) are added on their device.  Nothing
    is read back and no Python value is copied through an index.
    """
    tensors = {k: v for k, v in slots.items() if isinstance(v, torch.Tensor)}
    if device is None:
        device = next(iter(tensors.values())).device if tensors else "cpu"
    device = torch.device(device)
    host = np.zeros((NSLOTS,), np.float32)
    for name, value in slots.items():
        if name not in tensors:
            host[SLOT_INDEX[name]] += np.float32(value)
    vec = _upload(("v", str(device), host.tobytes()), host, device)
    if not tensors:
        return vec.clone()  # the cached upload must never be written
    idx_host = np.asarray([SLOT_INDEX[k] for k in tensors], np.int64)
    idx = _upload(("i", str(device), idx_host.tobytes()), idx_host, device)
    vals = torch.stack([t.reshape(()).to(device=device, dtype=torch.float32)
                        for t in tensors.values()])
    return vec.index_add(0, idx, vals)


def from_block(block: torch.Tensor) -> torch.Tensor:
    """In-kernel int32 counter block → ``(NSLOTS,)`` float32 vector."""
    return block.to(torch.float32)


def as_dict(vec: torch.Tensor) -> dict[str, float]:
    """Materialise a counter vector → {slot: value}.  This READS the device
    value — call it only at drain points (benches, bundles, tests)."""
    host = vec.detach().cpu().tolist()
    return {name: float(host[i]) for i, name in enumerate(SLOTS)}


# --------------------------------------------------------------------------
# tape — collect vectors recorded during one serving step.
# --------------------------------------------------------------------------

class Tape:
    """An ordered list of counter vectors recorded under one :func:`tape`."""

    __slots__ = ("vecs",)

    def __init__(self):
        self.vecs: list = []

    def add(self, vec) -> None:
        self.vecs.append(vec)

    def total(self, device: "torch.device | str" = "cpu") -> torch.Tensor:
        """Device sum of everything recorded (zeros on ``device`` when
        nothing was)."""
        if not self.vecs:
            return zeros(device)
        if len(self.vecs) == 1:
            return self.vecs[0]
        return torch.stack(self.vecs).sum(0)


_ACTIVE: list[Tape] = []


@contextlib.contextmanager
def tape():
    """Open a collection scope: :func:`record` calls inside land on the
    yielded tape.  Scopes nest (innermost wins)."""
    t = Tape()
    _ACTIVE.append(t)
    try:
        yield t
    finally:
        _ACTIVE.pop()


def record(vec) -> None:
    """Record a counter vector on the innermost active tape (no-op without
    one — ops can record unconditionally)."""
    if _ACTIVE:
        _ACTIVE[-1].add(vec)


def recording() -> bool:
    return bool(_ACTIVE)


# --------------------------------------------------------------------------
# plane — engine-side accumulator, drained through Counter.add_lazy.
# --------------------------------------------------------------------------

class DeviceCounterPlane:
    """Holds per-step counter vectors as device values; never syncs itself.

    ``add()`` is the hot-path call (a list append).  ``flush()`` sums the
    pending vectors on the device and hands one 0-d slice per slot to
    ``Counter.add_lazy`` — still no transfer; the registry's drain points
    (snapshot / metric reads) do the one read per counter.
    """

    PREFIX = "device."

    def __init__(self, registry):
        self.registry = registry
        self._pending: list = []

    @property
    def pending(self) -> int:
        return len(self._pending)

    def add(self, vec) -> None:
        self._pending.append(vec)

    def flush(self) -> None:
        """Move pending vectors into the registry as lazy counter adds (no
        device→host transfer happens here)."""
        if not self._pending:
            return
        tot = self._pending[0] if len(self._pending) == 1 else torch.stack(self._pending).sum(0)
        self._pending = []
        for i, name in enumerate(SLOTS):
            self.registry.counter(self.PREFIX + name, help="device counter plane slot").add_lazy(tot[i])

    def counters(self) -> dict[str, float]:
        """Flush + read every slot → {slot: value}.  This is a drain point
        (one read per counter with pending adds)."""
        self.flush()
        out = {}
        for name in SLOTS:
            c = self.registry.get(self.PREFIX + name)
            out[name] = float(c.total()) if c is not None else 0.0
        return out
