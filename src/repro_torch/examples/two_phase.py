"""The paper's case study (§VI.D) on the phase-aware runtime — twin of
``examples/two_phase.py`` on the port.

``TwoPhasePipeline`` makes the two-phase pattern an explicit state machine:

Phase 1 (GROW)   — waves of insertions with unknown final size; the
                   pipeline's GGArray grows copy-free (a doubling baseline
                   reallocates and copies every element on each growth).
freeze()         — the one-shot handoff: the segmented gather (K7 on a
                   card) flattens the bucket chain into a contiguous,
                   globally ordered FrozenArray.
Phase 2 (FROZEN) — the static pipeline: W work kernels run on the
                   contiguous buffer via ``map_frozen``.
thaw()           — optional return to GROW for the next ingest cycle.

``main`` takes its sizes as arguments: the example's five doubling waves
by default, or any list of wave sizes (``duplication_sizes`` gives the
paper's §VI schedule, ``configs.ggarray_demo``).  It asserts the §V
bound (capacity ≤ 2n + B0·blocks) and copy-free growth: no level that held
elements is ever reallocated.  Its waves append with ``method="auto"``, the
fused push-back (K3) on a card, where the reference example takes the
pipeline's default scan; both give the same positions and frozen array.

    PYTHONPATH=src python -m repro_torch.examples.two_phase [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.runtime import TwoPhasePipeline

__all__ = ["main", "work_kernel", "duplication_sizes", "wave"]


def work_kernel(x, repeats=30):
    for _ in range(repeats):
        x = x + 1
    return x


def duplication_sizes(start: int, duplications: int) -> list[int]:
    """The paper's §VI schedule as wave sizes: ``start`` elements, then
    ``duplications`` waves that each double the array (``start·2^d`` in all)."""
    return [start] + [start << k for k in range(duplications)]


def wave(nblocks: int, size: int, base: int, ids: bool, device) -> tuple:
    """One wave of ``size`` elements over ``nblocks`` blocks, ⌈size/nblocks⌉
    lanes a block, row-major → (elems, mask, lanes).  ``ids``: int32 lane
    ids ``base + lane``, else f32 ones.  The mask (numpy, so the planner
    counts exact per-block sizes) is None when ``size`` divides."""
    m = -(-size // nblocks)
    if ids:
        elems = (base + torch.arange(nblocks * m, dtype=torch.int32, device=device)).reshape(nblocks, m)
    else:
        elems = torch.ones((nblocks, m), dtype=torch.float32, device=device)
    mask = None if size % nblocks == 0 else np.arange(nblocks * m).reshape(nblocks, m) < size
    return elems, mask, nblocks * m


def _levels(pipe) -> set:
    return {(t.data_ptr(), t.numel() * t.element_size()) for t in pipe.array.buckets}


def main(nblocks: int = 8, waves: int = 5, start: int = 1 << 10, W: int = 100, repeats: int = 30, *,
         sizes=None, b0: int | None = None, ids: bool = False, check=None,
         device: "str | torch.device | None" = None) -> dict:
    """Grow → freeze → work → thaw and regrow → the numbers printed (the
    grow phase's as of the freeze), plus ``pipe``.  ``sizes``: the waves' sizes (default ``start·2^w``, w <
    ``waves``); ``b0`` (default ``start // nblocks``); ``ids``: int32 lane ids
    instead of f32 ones; ``check(pipe)`` runs on the frozen array after the work phase."""
    dev = resolve(device)
    sizes = [start << w for w in range(waves)] if sizes is None else list(sizes)
    b0 = start // nblocks if b0 is None else b0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ---- phase 1: grow ---------------------------------------------------
    t0 = time.perf_counter()
    pipe = TwoPhasePipeline(nblocks, b0=b0, dtype=torch.int32 if ids else torch.float32, device=dev)
    copied, base = 0, 0
    for size in sizes:
        elems, mask, lanes = wave(nblocks, size, base, ids, dev)
        before = _levels(pipe)
        pipe.append(elems, mask, method="auto")
        copied += sum(nbytes for _, nbytes in before - _levels(pipe))  # levels that moved
        base += lanes
        del elems
    sync()
    t_grow = time.perf_counter() - t0

    # ---- the handoff: freeze via the segmented flatten kernel ------------
    frozen = pipe.freeze()
    total = int(frozen.size)
    capacity = pipe.memory_elems()
    grown = {"waves": pipe.stats.appends, "grow_events": pipe.stats.grow_events,
             "host_syncs": pipe.stats.host_syncs}
    bound = capacity <= 2 * total + pipe.array.b0 * nblocks
    print(f"grow phase: {total} elements in {pipe.stats.appends} waves, "
          f"{pipe.stats.grow_events} growth events (copy-free), "
          f"capacity {capacity} "
          f"(≤2x: {bound}), "
          f"{t_grow * 1e3:.1f} ms")
    print(f"freeze: {pipe.stats.last_freeze_s * 1e3:.1f} ms "
          f"(segmented gather, O(n); a first freeze on a card includes building K7)")
    assert bound, f"capacity {capacity} above 2n + B0·blocks = {2 * total + pipe.array.b0 * nblocks}"
    assert copied == 0, f"growth moved {copied} bytes of levels"

    # ---- phase 2: static work on the frozen array ------------------------
    t0 = time.perf_counter()

    def fn(x):
        for _ in range(W):
            x = work_kernel(x, repeats)
        return x

    pipe.map_frozen(fn)
    sync()
    t_work = time.perf_counter() - t0
    print(f"work phase: {W} kernels on frozen array, {t_work * 1e3:.1f} ms")
    t_freeze = pipe.stats.last_freeze_s
    print(f"grow+freeze overhead amortized: "
          f"{(t_grow + t_freeze) / (t_grow + t_freeze + t_work) * 100:.1f}% of total")
    if check is not None:
        check(pipe)

    # ---- thaw: the cycle can repeat --------------------------------------
    pipe.thaw()
    pipe.append(torch.ones((nblocks, 16), dtype=pipe.array.dtype, device=dev))
    print(f"thawed and regrew: {pipe.total_size()} elements, "
          f"phase={pipe.phase.value}")
    return {"elements": total, **grown, "capacity": capacity, "copied_bytes": copied,
            "bound_ok": bound, "grow_s": t_grow, "freeze_s": t_freeze, "work_s": t_work, "pipe": pipe}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    main(device=ap.parse_args().device)
