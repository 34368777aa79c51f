"""Quickstart: the GGArray public API in five minutes — twin of
``examples/quickstart.py`` on the port.

Covers the paper's core objects bottom-up — LFVector (Algs. 1–2), GGArray
(block-parallel push_back, rw_g indexing), the three insertion algorithms —
then the intended way to consume them: ``runtime.TwoPhasePipeline``, which
owns the grow → freeze (linear-time segmented flatten) → static-read
lifecycle.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch import core
from repro_torch.device import resolve
from repro_torch.runtime import TwoPhasePipeline


def main(device: "str | torch.device | None" = None) -> dict:
    dev = resolve(device)
    # --- single LFVector: the paper's Algorithms 1-2 ----------------------
    v = core.LFVector.create(b0=4, device=dev)
    v.push_back(torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0], device=dev))  # grows automatically
    v[2] = 30.0
    print("LFVector:", v.to_array(), f"(len={len(v)}, capacity={v.capacity}, "
          f"buckets={v.nbuckets})")

    # --- GGArray: one LFVector per block, block-local parallel insertion --
    nblocks = 4
    arr = core.init(nblocks, b0=4, device=dev)
    arr = core.ensure_capacity(arr, 6)

    elems = torch.arange(24, dtype=torch.float32, device=dev).reshape(nblocks, 6)
    mask = elems % 3 != 0  # only some lanes insert — scan assigns dense slots
    arr, positions = core.push_back(arr, elems, mask, method="scan")
    print("per-block sizes:", arr.sizes, " capacity/block:", arr.capacity_per_block)
    print("assigned in-block positions:\n", positions)

    # --- the three insertion algorithms agree (paper §III.B) --------------
    counts = {}
    for method in ("atomic", "scan", "mxu"):
        off, cnt = core.insertion_offsets(mask, method=method)
        counts[method] = cnt
        print(f"insertion[{method}]: counts={cnt}")

    # --- the hot path: in-place append + host-side planner ----------------
    # Steady-state waves read nothing from the device: the planner proves
    # capacity from its host-side bound; the headroom flag is read only when
    # a growth might be needed — O(log n) host contacts in all.
    planner = core.CapacityPlanner.for_array(arr)
    wave = torch.ones((nblocks, 2), dtype=torch.float32, device=dev)
    for _ in range(3):
        arr = planner.reserve(arr, 2)
        arr, _, headroom = core.append(arr, wave)
        planner.note_append(arr, headroom)
    print(f"amortized appends: sizes={arr.sizes}, host syncs={planner.host_syncs}")

    # --- global indexing: prefix-sum table + binary search (rw_g) ---------
    flat, total = core.flatten(arr)
    idx = torch.arange(int(total), device=dev)
    print("rw_g read:", core.read_global(arr, idx)[:8], "...")
    print("flatten :", flat[: int(total)][:8], "...")

    # --- memory bound: capacity < 2x size + B0 (paper §V) -----------------
    n = int(total)
    alloc = core.memory_elems(arr)
    print(f"memory: size={n} allocated={alloc} (bound 2n+B0·blocks={2 * n + 4 * nblocks})")

    # --- the two-phase runtime: grow → freeze → static reads (§VI.D) ------
    pipe = TwoPhasePipeline(nblocks=4, b0=4, device=dev)
    pipe.append(torch.arange(12, dtype=torch.float32, device=dev).reshape(4, 3))
    frozen = pipe.freeze()  # linear-time segmented flatten kernel
    print(f"two-phase: froze {int(frozen.size)} elements, "
          f"contiguous read: {frozen.read(torch.arange(4, device=dev))}")
    pipe.thaw()  # copy-free return to the grow phase
    return {"lfvector": v.to_array(), "sizes": arr.sizes, "positions": positions, "counts": counts,
            "flat": flat[:n], "n": n, "alloc": alloc, "frozen": frozen.data, "host_syncs": planner.host_syncs}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    main(ap.parse_args().device)
