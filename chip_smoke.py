#!/usr/bin/env python3
"""Build the PyTorch/CUDA port and drive it on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Run from the root of the repository.  Phases, one JSON line each:

1. device — the card's name and power limit (``nvidia-smi``); TF32 off.
2. build — every ``src/repro_torch/csrc/*.cu`` compiled by ``nvcc``.
3. kernels — K1 (row scan), K3 (push-back), K6 (compaction) and K7
   (segmented gather) against their plain PyTorch versions, bitwise, at
   small ragged shapes and at the main path's shapes, with the kernel's,
   the plain version's and (where one exists) a library call's times and
   the bytes bound.
4. main path — ``TwoPhasePipeline(nblocks=512, b0=2048)`` grown by eight
   doubling waves to about 2.4e8 float32 elements, frozen, read at 2^24
   random indices and checked bitwise against a numpy expectation; thawed,
   grown by one more wave, refrozen and checked again; the same at one
   eighth of the size with ``method="tile"``; then 16 steady-state appends
   under ``torch.cuda.set_sync_debug_mode("error")``.  Launch counts are
   zeroed just before this phase and read just after it.
5. kernels — one line listing every ported kernel.
6. the last line: ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero.  Without a CUDA
device, or outside a checkout of the repository, it prints no result and
exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Peak device-memory bandwidth (bytes/s) by card, from NVIDIA's data sheets.
PEAK_BYTES_PER_S = (
    ("H100 PCIe", 2.0e12),
    ("H100 NVL", 3.9e12),
    ("H200", 4.8e12),
    ("H100", 3.35e12),  # SXM / HBM3
)
# Integer adds and compares run on the CUDA cores: the fp32 non-tensor peak.
PEAK_OPS_PER_S = 67e12

KERNELS = {
    "row_scan": ("src/repro_torch/csrc/scan_tile.cu",
                 "src/repro/kernels/scan_tile/kernel.py:36"),
    "push_back": ("src/repro_torch/csrc/push_back.cu",
                  "src/repro/kernels/push_back/kernel.py:255"),
    "compact_blocks": ("src/repro_torch/csrc/flatten.cu",
                       "src/repro/kernels/flatten/kernel.py:94"),
    "segmented_gather": ("src/repro_torch/csrc/flatten.cu",
                         "src/repro/kernels/flatten/kernel.py:210"),
}

NBLOCKS, B0, NWAVES = 512, 2048, 8
STEADY_M, STEADY_WAVES = 64, 16
DEV = "cuda"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def peak_bytes_per_s(name: str) -> float:
    for key, rate in PEAK_BYTES_PER_S:
        if key in name:
            return rate
    raise RuntimeError(f"no bandwidth figure for card {name!r}")


def bound_ms(nbytes: float, nops: float, name: str) -> tuple[float, str]:
    t_bytes = nbytes / peak_bytes_per_s(name) * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bits(t):
    """A tensor's bit pattern as an integer tensor (so -0.0 != 0.0, NaN == NaN)."""
    import torch

    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64, 1: torch.uint8}[t.element_size()])


def compare(a, b) -> tuple[int, float]:
    """(elements whose bits differ, max |a - b| in float64)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel(), 1), float("inf")
    if a.numel() == 0:
        return 0, 0.0
    mism = int((bits(a) != bits(b)).sum().item())
    return mism, float((a.double() - b.double()).abs().max().item())


# --------------------------------------------------------------------------
# Phase 3: each kernel against its plain version.
# --------------------------------------------------------------------------

def kernel_phase(card: str, gen) -> dict:
    import torch

    from repro_torch.core import indexing
    from repro_torch.kernels.flatten import kernel as k_fl
    from repro_torch.kernels.flatten import ref as r_fl
    from repro_torch.kernels.push_back import kernel as k_pb
    from repro_torch.kernels.push_back import ref as r_pb
    from repro_torch.kernels.scan_tile import kernel as k_st
    from repro_torch.kernels.scan_tile import ref as r_st

    dev = torch.device(DEV)
    res = {k: {"mismatches": 0, "max_abs_err": 0.0, "cases": 0} for k in KERNELS}

    def note(name, pairs):
        for a, b in pairs:
            mism, err = compare(a, b)
            res[name]["mismatches"] += mism
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        res[name]["cases"] += 1

    def rand_payload(shape, dtype):
        if dtype == torch.int32:
            return torch.randint(-1000, 1000, shape, generator=gen, device=dev, dtype=dtype)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def levels_of(n, b0, nlev, dtype, item=()):
        return tuple(rand_payload((n, w, *item), dtype) for w in indexing.bucket_sizes(b0, nlev))

    def k3_case(n, b0, nlev, m, dtype, sizes, item=(), p_live=0.6):
        levels = levels_of(n, b0, nlev, dtype, item)
        elems = rand_payload((n, m, *item), dtype)
        mask = torch.rand((n, m), generator=gen, device=dev) < p_live
        la, lb = tuple(x.clone() for x in levels), tuple(x.clone() for x in levels)
        sa, pa = k_pb.push_back_cuda(la, sizes, b0, elems, mask)
        _, sb, pb_ = r_pb.push_back(lb, sizes, b0, elems, mask)
        note("push_back", [(sa, sb), (pa, pb_), *zip(la, lb)])
        return levels, elems, mask, la

    def k67_case(levels, b0, sizes):
        ca, cb = k_fl.compact_blocks_cuda(levels, b0), r_fl.compact_blocks(levels, b0)
        note("compact_blocks", [(ca, cb)])
        starts = indexing.block_starts(sizes)
        ends = starts + sizes
        note("segmented_gather", [(k_fl.segmented_gather_cuda(ca, starts, ends),
                                   r_fl.gather_global(ca, starts, ends))])

    # Small ragged shapes: N a multiple of nothing, m = 1 and 130, one and
    # nine levels, three payload types, waves that overflow capacity, and
    # empty blocks for the gather.
    for rows, cols in ((1, 1), (3, 7), (37, 130), (5, 2049), (2, 100_003)):
        x = (torch.rand((rows, cols), generator=gen, device=dev) < 0.5).to(torch.int32)
        note("row_scan", [(k_st.row_scan_cuda(x), r_st.row_scan(x))])
        x = torch.randint(-50, 50, (rows, cols), generator=gen, device=dev, dtype=torch.int32)
        note("row_scan", [(k_st.row_scan_cuda(x), r_st.row_scan(x))])
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for n, b0, nlev, m, item in ((37, 3, 1, 1, ()), (37, 2, 9, 130, ()), (5, 4, 4, 130, ()),
                                     (2, 2, 1, 9, ()), (13, 8, 5, 64, (3,)), (7, 1, 9, 130, ())):
            cap = indexing.capacity(b0, nlev)
            sizes = torch.randint(0, cap + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
            _, _, _, written = k3_case(n, b0, nlev, m, dtype, sizes, item)
            if not item:
                live = torch.minimum(sizes, torch.full_like(sizes, cap))
                live[::3] = 0  # empty blocks
                k67_case(written, b0, live)

    # Main-path shapes: 512 blocks, b0 = 2048, 8 levels; the last grow wave
    # (m = 2048 * 2^7) onto sizes where the seventh wave left them.
    m_last = B0 << (NWAVES - 1)
    n_lev = NWAVES
    sizes = torch.full((NBLOCKS,), int(0.9 * B0 * (2 ** (NWAVES - 1) - 1)), dtype=torch.int32, device=dev)
    sizes += torch.randint(-(B0 // 4), B0 // 4, (NBLOCKS,), generator=gen, device=dev, dtype=torch.int32)
    levels, elems, mask, written = k3_case(NBLOCKS, B0, n_lev, m_last, torch.float32, sizes, p_live=0.9)
    live_lanes = int(mask.sum().item())
    timing = {}
    la = tuple(x.clone() for x in levels)
    timing["push_back"] = dict(
        ms=cuda_ms(lambda: k_pb.push_back_cuda(la, sizes, B0, elems, mask), 10),
        plain_ms=cuda_ms(lambda: r_pb.push_back(la, sizes, B0, elems, mask), 2),
        library_ms=None,
        bound=bound_ms(NBLOCKS * m_last * (1 + 4 + 4) + 8 * NBLOCKS + 4 * live_lanes,
                       NBLOCKS * m_last, card),
        shape=f"levels {n_lev} x ({NBLOCKS}, {B0}*2^b) f32, wave ({NBLOCKS}, {m_last}), live {live_lanes}",
    )
    del la, levels, elems, mask
    final_sizes = torch.full((NBLOCKS,), int(0.9 * B0 * (2 ** NWAVES - 1)), dtype=torch.int32, device=dev)
    final_sizes += torch.randint(-(B0 // 2), B0 // 2, (NBLOCKS,), generator=gen, device=dev, dtype=torch.int32)
    k67_case(written, B0, final_sizes)
    cap = indexing.capacity(B0, n_lev)
    plane_bytes = NBLOCKS * cap * 4
    timing["compact_blocks"] = dict(
        ms=cuda_ms(lambda: k_fl.compact_blocks_cuda(written, B0), 10),
        plain_ms=cuda_ms(lambda: r_fl.compact_blocks(written, B0), 10),
        library_ms=cuda_ms(lambda: torch.cat(written, 1), 10),
        bound=bound_ms(2 * plane_bytes, 0, card),
        shape=f"levels {n_lev} x ({NBLOCKS}, {B0}*2^b) f32 -> ({NBLOCKS}, {cap})",
    )
    compact = k_fl.compact_blocks_cuda(written, B0)
    del written
    starts = indexing.block_starts(final_sizes)
    ends = starts + final_sizes
    n_live = int(final_sizes.sum().item())
    timing["segmented_gather"] = dict(
        ms=cuda_ms(lambda: k_fl.segmented_gather_cuda(compact, starts, ends), 10),
        plain_ms=cuda_ms(lambda: r_fl.gather_global(compact, starts, ends), 2),
        library_ms=None,
        bound=bound_ms(4 * n_live + 8 * NBLOCKS + plane_bytes,
                       NBLOCKS * cap * (NBLOCKS.bit_length()), card),
        shape=f"plane ({NBLOCKS}, {cap}) f32, {n_live} live",
    )
    del compact
    # K1 at the largest wave of the main path's tile run (one eighth size).
    x = (torch.rand((NBLOCKS, m_last // 8), generator=gen, device=dev) < 0.9).to(torch.int32)
    note("row_scan", [(k_st.row_scan_cuda(x), r_st.row_scan(x))])
    timing["row_scan"] = dict(
        ms=cuda_ms(lambda: k_st.row_scan_cuda(x), 20),
        plain_ms=cuda_ms(lambda: r_st.row_scan(x), 20),
        library_ms=cuda_ms(lambda: torch.cumsum(x, 1), 20),
        bound=bound_ms(8 * x.numel(), x.numel(), card),
        shape=f"({NBLOCKS}, {m_last // 8}) int32",
    )
    del x
    torch.cuda.synchronize()
    for name in KERNELS:
        r, t = res[name], timing[name]
        r.update(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"],
                 bound_ms=t["bound"][0], bound_by=t["bound"][1], shape=t["shape"])
        emit({"phase": "kernel", "name": name, "card": card, **r})
        check(r["mismatches"] == 0, f"{name}: {r['mismatches']} elements differ from the plain version")
    return res


# --------------------------------------------------------------------------
# Phase 4: the main path.
# --------------------------------------------------------------------------

def expected_order(waves) -> "np.ndarray":
    """numpy expectation: each block's live lanes in lane order, wave after
    wave, blocks concatenated — built without the port."""
    import numpy as np

    per_block = [[] for _ in range(waves[0][0].shape[0])]
    for vals, mask in waves:
        for b in range(vals.shape[0]):
            per_block[b].append(vals[b][mask[b]])
    return np.concatenate([np.concatenate(chunks) for chunks in per_block])


def check_frozen(pipe, waves, card: str, what: str) -> dict:
    import numpy as np
    import torch

    frozen = pipe.frozen
    want = expected_order(waves)
    n = int(frozen.size.item())
    check(n == want.size, f"{what}: size {n} != {want.size}")
    data = frozen.data
    got = data[:n].cpu().numpy()
    check(np.array_equal(got.view(np.uint32), want.view(np.uint32)), f"{what}: data[:n] differs")
    check(int(torch.count_nonzero(data[n:].view(torch.int32)).item()) == 0, f"{what}: data[n:] not 0")
    counts = np.asarray([sum(int(m[b].sum()) for _, m in waves) for b in range(NBLOCKS)])
    check(np.array_equal(frozen.block_starts.cpu().numpy(), np.cumsum(counts) - counts),
          f"{what}: block_starts differ")
    alloc = pipe.memory_elems()
    check(alloc < 2 * n + pipe.array.b0 * NBLOCKS, f"{what}: §V bound alloc < 2n + B0*blocks fails")
    return {"n": n, "alloc": alloc, "want": want}


def grow(pipe, rng, m0: int, method: str, card: str) -> tuple[list, float]:
    import numpy as np
    import torch

    waves, t_grow = [], 0.0
    for w in range(NWAVES):
        m = m0 << w
        vals = rng.standard_normal((NBLOCKS, m), dtype=np.float32)
        mask = rng.random((NBLOCKS, m), dtype=np.float32) < 0.9
        dev_vals = torch.from_numpy(vals).to(DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.append(dev_vals, mask, method=method)  # numpy mask: exact per-block bounds
        torch.cuda.synchronize()
        t_grow += time.perf_counter() - t0
        waves.append((vals, mask))
        del dev_vals
    return waves, t_grow


def main_path(card: str, seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.runtime import TwoPhasePipeline

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 1)
    torch.cuda.reset_peak_memory_stats()
    common.reset_launch_counts()

    # grow -> freeze -> read, full size, method="auto" (K3 at every width)
    pipe = TwoPhasePipeline(nblocks=NBLOCKS, b0=B0, device=DEV)
    waves, t_grow = grow(pipe, rng, B0, "auto", card)
    t0 = time.perf_counter()
    pipe.freeze()
    t_freeze = time.perf_counter() - t0
    full = check_frozen(pipe, waves, card, "freeze")
    n = full["n"]
    idx = torch.randint(0, n, (1 << 24,), generator=gen, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pipe.read(idx)
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    want_read = full.pop("want")[idx.cpu().numpy()]
    check(np.array_equal(got.cpu().numpy().view(np.uint32), want_read.view(np.uint32)), "reads differ")
    emit({"phase": "main.freeze", "card": card, "elements": n, "alloc_elems": full["alloc"],
          "levels": pipe.array.nbuckets, "grow_s": t_grow, "freeze_s": t_freeze,
          "read_s": t_read, "reads": 1 << 24, "host_syncs": pipe.stats.host_syncs,
          "grow_events": pipe.stats.grow_events, "ok": True})

    # thaw -> one more wave (K3) -> refreeze
    pipe.thaw()
    vals = rng.standard_normal((NBLOCKS, 64), dtype=np.float32)
    mask = rng.random((NBLOCKS, 64), dtype=np.float32) < 0.9
    pipe.append(torch.from_numpy(vals).to(DEV), mask, method="auto")
    waves.append((vals, mask))
    t0 = time.perf_counter()
    pipe.freeze()
    t_refreeze = time.perf_counter() - t0
    again = check_frozen(pipe, waves, card, "refreeze")
    del again["want"], waves
    emit({"phase": "main.refreeze", "card": card, "elements": again["n"],
          "refreeze_s": t_refreeze, "ok": True})

    # steady state: 16 device-made m=64 appends, no host sync allowed
    pipe.thaw()
    dwaves = [(torch.randn((NBLOCKS, STEADY_M), generator=gen, device=DEV),
               torch.rand((NBLOCKS, STEADY_M), generator=gen, device=DEV) < 0.9)
              for _ in range(STEADY_WAVES)]
    torch.cuda.synchronize()
    syncs = pipe.stats.host_syncs
    torch.cuda.set_sync_debug_mode("error")
    try:
        for v, mk in dwaves:
            pipe.append(v, mk, method="auto")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(pipe.stats.host_syncs == syncs, "steady-state appends made a planner host sync")
    live = int(sum(mk.sum() for _, mk in dwaves).item())
    check(pipe.total_size() == again["n"] + live, "steady-state appends lost elements")
    emit({"phase": "main.steady", "card": card, "appends": STEADY_WAVES, "m": STEADY_M, "host_syncs_added": 0,
          "elements": again["n"] + live, "ok": True})
    del pipe, dwaves
    peak = torch.cuda.max_memory_allocated()

    # grow -> freeze at one eighth of the size with method="tile" (K1)
    small = TwoPhasePipeline(nblocks=NBLOCKS, b0=B0 // 8, device=DEV)
    waves, t_grow_tile = grow(small, rng, B0 // 8, "tile", card)
    t0 = time.perf_counter()
    small.freeze()
    t_freeze_tile = time.perf_counter() - t0
    tile = check_frozen(small, waves, card, "tile freeze")
    emit({"phase": "main.tile", "card": card, "elements": tile["n"], "grow_s": t_grow_tile,
          "freeze_s": t_freeze_tile, "ok": True})
    del small, waves

    torch.cuda.synchronize()
    launches = common.launch_counts()
    emit({"phase": "main.launches", "card": card, "launches": launches,
          "peak_device_bytes": peak})
    for name in KERNELS:
        check(launches[name] >= 1, f"kernel {name} never launched on the main path")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found: run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()} limit)"
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False})

    # 2. build
    from repro_torch.kernels import _build

    info = _build.build_all()
    regs = {k: [ln.strip() for ln in v.splitlines() if "Used" in ln] for k, v in info["log"].items()}
    emit({"phase": "build", "seconds": info["seconds"], "built": info["built"], "ptxas": regs})

    # 3. kernels against their plain versions
    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)
    res = kernel_phase(card, gen)
    torch.cuda.empty_cache()

    # 4. main path
    launches = main_path(card, args.seed)

    # 5. the kernels line
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": launches[name], "mismatches": res[name]["mismatches"],
         "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
         "plain_ms": res[name]["plain_ms"], "bound_ms": res[name]["bound_ms"],
         "bound_by": res[name]["bound_by"], "library_ms": res[name]["library_ms"],
         "shape": res[name]["shape"], "card": card}
        for name in KERNELS
    ]})
    # 6. the last line
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
