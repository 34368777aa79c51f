#!/usr/bin/env python3
"""Build the PyTorch/CUDA port and drive it on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Run from the root of the repository.  Phases, one JSON line each:

1. device — the card's name and power limit (``nvidia-smi``); TF32 off.
2. build — every ``src/repro_torch/csrc/*.cu`` compiled by ``nvcc``.
3. kernels — K1 (row scan), K3 (push-back), K6 (compaction), K7
   (segmented gather), K8/K9 (paged gather, one extent / many) and K12
   (slab append) against their plain PyTorch versions, bitwise, at small
   ragged shapes (three payload types, scalar and (8, 128) items, flat /
   doubling / tz extents, page -1, fuzzed owner tables) and at the main
   paths' shapes, with the kernel's, the plain version's and (where one
   exists) a library call's times and the bytes bound.
4. main path — ``TwoPhasePipeline(nblocks=512, b0=2048)`` grown by eight
   doubling waves to about 2.4e8 float32 elements, frozen, read at 2^24
   random indices and checked bitwise against a numpy expectation; thawed,
   grown by one more wave, refrozen and checked again; the same at one
   eighth of the size with ``method="tile"``; then 16 steady-state appends
   under ``torch.cuda.set_sync_debug_mode("error")``.
5. arena paths — ``TwoPhasePipeline.from_arena(SlabArena(512, 2048,
   grow_chunk="doubling"))`` grown by the same eight waves, frozen, read and
   checked; every 4th array released and one more wave grown into the freed
   slabs (the pool must not grow), invariants and capacity bounds checked,
   zero pool bytes copied, refrozen; 16 steady-state appends under the
   sync check.  The same at one eighth of the size with the flat
   ``"geometric"`` layout.  The KV-shaped arena (64 arrays of (8, 128) bf16
   items in 2048-token slabs: one ragged prefill wave, 32 decode waves, the
   logical view and the flatten checked bitwise).  ``Packer(backend="arena")``
   against ``Packer(backend="pipeline")`` on 256 documents.
6. kernels — one line listing every ported kernel.
7. the last line: ``{"ok": true, "device": {...}}``.

Launch counts are zeroed just before each path and read just after it; a
kernel of a path that never launched fails the run.  Any failed check raises and the script exits non-zero.  Without a CUDA
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
    "paged_gather": ("src/repro_torch/csrc/paged.cu",
                     "src/repro/kernels/paged/kernel.py:124"),
    "paged_gather_extents": ("src/repro_torch/csrc/paged.cu",
                             "src/repro/kernels/paged/kernel.py:229"),
    "slab_append": ("src/repro_torch/csrc/paged.cu",
                    "src/repro/kernels/paged/kernel.py:687"),
}

SLICE1_KERNELS = ("row_scan", "push_back", "compact_blocks", "segmented_gather")

NBLOCKS, B0, NWAVES = 512, 2048, 8
STEADY_M, STEADY_WAVES = 64, 16
# The KV-shaped arena: one layer's K of qwen3-32b (n_kv_heads=8, d_head=128,
# src/repro/configs/qwen3_32b.py) in slabs of its default slab_tokens (2048,
# src/repro/configs/base.py), 64 sequences of 1024-16384 prefill tokens,
# then 32 decode steps.
KV_ARRAYS, KV_ITEM, KV_MIN, KV_MAX, KV_DECODE = 64, (8, 128), 1024, 16384, 32
PACK_DOCS, PACK_MIN, PACK_MAX, PACK_BLOCKS = 256, 512, 8192, 64
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
    if mism == 0:
        return 0, 0.0
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
    torch.cuda.empty_cache()
    paged_cases(card, rand_payload, note, timing)
    torch.cuda.synchronize()
    for name in KERNELS:
        r, t = res[name], timing[name]
        r.update(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"],
                 bound_ms=t["bound"][0], bound_by=t["bound"][1], shape=t["shape"])
        emit({"phase": "kernel", "name": name, "card": card, **r})
        if "extra" in t:
            emit({"phase": "kernel.kv", "name": name, "card": card, **t["extra"]})
        check(r["mismatches"] == 0, f"{name}: {r['mismatches']} elements differ from the plain version")
    return res


def _extent_sizes(S: int, layout: str) -> list:
    """Extent sizes covering at least ``S`` slabs: one flat extent, the
    doubling schedule from S/8, or the Tarjan-Zwick sequence."""
    from repro_torch.pool import extents as ext_mod

    if layout == "flat":
        return [S]
    if layout == "tz":
        return ext_mod.plan_extents((), S, "tz")
    sizes = [max(S // 8, 1)]
    while sum(sizes) < S:
        sizes += ext_mod.plan_extents(tuple(sizes), S - sum(sizes), "doubling")
    return sizes


def _split(flat, sizes):
    out, lo = [], 0
    for n in sizes:
        out.append(flat[lo:lo + n].clone())
        lo += n
    return tuple(out)


def _arena_tables(npages_per_array, S_total, T, gen):
    """owners/bases/pages as the arena builds them: array i holds pages
    0..npages[i]-1 on slabs drawn at random from the pool; the rest free."""
    import torch

    N = len(npages_per_array)
    P = max(max(npages_per_array), 1)
    perm = torch.randperm(S_total, generator=gen, device=gen.device).cpu()
    owners = torch.full((S_total,), -1, dtype=torch.int32)
    bases = torch.zeros((S_total,), dtype=torch.int32)
    pages = torch.full((N, P), -1, dtype=torch.int32)
    k = 0
    for i, c in enumerate(npages_per_array):
        ids = perm[k:k + c]
        k += c
        owners[ids] = i
        bases[ids] = torch.arange(c, dtype=torch.int32) * T
        pages[i, :c] = ids.to(torch.int32)
    return owners.to(DEV), bases.to(DEV), pages.to(DEV)


def paged_cases(card: str, payload, note, timing) -> None:
    """K8, K9 and K12 against their plain versions, then timed at the main
    paths' shapes."""
    import torch

    from repro_torch.kernels.paged import kernel as k_pg
    from repro_torch.kernels.paged import ref as r_pg

    dev = torch.device(DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(12)

    def flat3(exts):
        return [e.reshape(e.shape[0], e.shape[1], -1) for e in exts]

    def gather_case(exts, pages):
        got = k_pg.paged_gather_cuda(exts, pages, clip_high=len(exts) == 1)
        f = flat3(exts)
        want = r_pg.gather_pages(f[0], pages) if len(f) == 1 else r_pg.gather_pages_extents(tuple(f), pages)
        note("paged_gather" if len(exts) == 1 else "paged_gather_extents", [(got, want.reshape(got.shape))])

    def append_case(exts, owners, bases, sizes, elems, mask):
        N, m = mask.shape
        work = tuple(e.clone() for e in exts)
        ns, pos = k_pg.slab_append_cuda(work, owners, bases, sizes, elems, mask)
        want_pool, want_sizes, want_pos = r_pg.slab_append(
            torch.cat(flat3(exts)), owners, bases, sizes, elems.reshape(N, m, -1), mask)
        note("slab_append", [(torch.cat(flat3(work)), want_pool), (ns, want_sizes), (pos, want_pos)])

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    # Small ragged cases: three payload types, scalar and (8, 128) items, one
    # extent / doubling / tz extents, page -1 and ids past the pool, fuzzed
    # owners/bases tables (free slabs, owners past N, overlapping windows,
    # misaligned bases), waves wider than one 1024-lane chunk, and lanes
    # past every claimed slab.
    for dtype in (torch.float32, torch.int32, torch.bfloat16):
        for item in ((), (8, 128)):
            for layout in ("flat", "doubling", "tz"):
                T, N, P = 5, 7, 6
                sizes_e = _extent_sizes(13, layout)
                S = sum(sizes_e)
                exts = _split(payload((S, T, *item), dtype), sizes_e)
                pages = ints(-1, S, (N, P))
                pages[0, 0], pages[1, 2] = S, S + 9  # past the pool
                gather_case(exts, pages)
                gather_case(exts, pages[:1, :1].contiguous())
                for m in (1, 37, 1100 if not item else 70):
                    owners = ints(-1, N + 1, (S,))
                    bases = ints(0, P, (S,)) * T + ints(-1, 2, (S,)) * ints(0, 2, (S,))
                    sizes = ints(0, 3 * T, (N,))
                    elems = payload((N, m, *item), dtype)
                    mask = torch.rand((N, m), generator=gen, device=dev) < 0.7
                    append_case(exts, owners, bases, sizes, elems, mask)
                # arena-built tables where the wave overruns the claimed slabs
                owners, bases, _ = _arena_tables([1, 2, 0, 1, 2, 1, 1], S, T, gen)
                m = 3 * T
                append_case(exts, owners, bases, ints(0, T, (N,)), payload((N, m, *item), dtype),
                            torch.ones((N, m), dtype=torch.bool, device=dev))
                del exts

    # Main-path shapes.  K12: the scalar arena's last grow wave (512 arrays,
    # slabs of 2048, m = 2048 * 2^7 onto sizes where seven waves left them),
    # the pool in doubling extents.  K9: the freeze's gather of that arena.
    m_last = B0 << (NWAVES - 1)
    sizes = torch.full((NBLOCKS,), int(0.9 * B0 * (2 ** (NWAVES - 1) - 1)), dtype=torch.int32, device=dev)
    sizes += ints(-(B0 // 2), B0 // 2, (NBLOCKS,))
    mask = torch.rand((NBLOCKS, m_last), generator=gen, device=dev) < 0.9
    after = (sizes + mask.sum(1, dtype=torch.int32)).cpu().tolist()
    npages = [-(-a // B0) for a in after]
    sizes_e = _extent_sizes(sum(npages), "doubling")
    S = sum(sizes_e)
    owners, bases, pages = _arena_tables(npages, S, B0, gen)
    exts = _split(payload((S, B0), torch.float32), sizes_e)
    elems = payload((NBLOCKS, m_last), torch.float32)
    append_case(exts, owners, bases, sizes, elems, mask)
    live = int(mask.sum().item())
    flat = torch.cat(exts)
    timing["slab_append"] = dict(
        ms=cuda_ms(lambda: k_pg.slab_append_cuda(exts, owners, bases, sizes, elems, mask), 10),
        plain_ms=cuda_ms(lambda: r_pg.slab_append(flat[:, :, None], owners, bases, sizes,
                                                  elems[:, :, None], mask), 1),
        library_ms=None,
        bound=bound_ms(NBLOCKS * m_last * (1 + 4 + 4) + 4 * live + 12 * NBLOCKS + 8 * S, 0, card),
        shape=f"pool {len(exts)} extents, {S} slabs x {B0} f32; wave ({NBLOCKS}, {m_last}), live {live}",
    )
    # the freeze reads every claimed page of that arena
    k_pg.slab_append_cuda(exts, owners, bases, sizes, elems, mask)
    del elems, mask, flat
    gather_case(exts, pages)
    n_live_pages = int((pages >= 0).sum().item())
    out_bytes = pages.numel() * B0 * 4
    flat = torch.cat(exts)
    idx = pages.clamp(min=0).flatten().long()
    timing["paged_gather_extents"] = dict(
        ms=cuda_ms(lambda: k_pg.paged_gather_cuda(exts, pages, clip_high=False), 10),
        plain_ms=cuda_ms(lambda: r_pg.gather_pages_extents(tuple(e[:, :, None] for e in exts), pages), 2),
        library_ms=cuda_ms(lambda: flat.index_select(0, idx), 10),
        bound=bound_ms(n_live_pages * B0 * 4 + pages.numel() * 4 + out_bytes, 0, card),
        shape=f"pages ({NBLOCKS}, {pages.shape[1]}), {n_live_pages} live, over {len(exts)} extents of {B0} f32",
    )
    del exts, flat, idx, owners, bases, pages
    torch.cuda.empty_cache()

    # K8: the freeze's gather of the 1/8-size flat ("geometric") arena.
    t8 = B0 // 8
    npages = [-(-int(0.9 * t8 * (2 ** NWAVES - 1) + j) // t8) for j in range(0, 4 * NBLOCKS, 4)]
    S = 2 * sum(npages)  # geometric growth leaves up to half the pool free
    _, _, pages = _arena_tables(npages, S, t8, gen)
    pool = payload((S, t8), torch.float32)
    gather_case((pool,), pages)
    n_live_pages = int((pages >= 0).sum().item())
    idx = pages.clamp(min=0).flatten().long()
    timing["paged_gather"] = dict(
        ms=cuda_ms(lambda: k_pg.paged_gather_cuda((pool,), pages, clip_high=True), 20),
        plain_ms=cuda_ms(lambda: r_pg.gather_pages(pool[:, :, None], pages), 5),
        library_ms=cuda_ms(lambda: pool.index_select(0, idx), 20),
        bound=bound_ms(n_live_pages * t8 * 4 + pages.numel() * 4 + pages.numel() * t8 * 4, 0, card),
        shape=f"pages ({NBLOCKS}, {pages.shape[1]}), {n_live_pages} live, flat pool {S} x {t8} f32",
    )
    del pool, pages, idx
    torch.cuda.empty_cache()

    # KV-shaped: the prefill wave (K12 on one extent) and the logical view
    # after the decode steps (K9 over two extents), (8, 128) bf16 items.
    lens = ints(KV_MIN, KV_MAX + 1, (KV_ARRAYS,))
    mask = torch.arange(KV_MAX, device=dev)[None, :] < lens[:, None]
    npages = [-(-(int(n) + KV_DECODE) // B0) for n in lens.cpu().tolist()]
    S = sum(npages)
    owners, bases, pages = _arena_tables(npages, S, B0, gen)
    pool = torch.zeros((S, B0, *KV_ITEM), dtype=torch.bfloat16, device=dev)
    elems = payload((KV_ARRAYS, KV_MAX, *KV_ITEM), torch.bfloat16)
    zeros = torch.zeros((KV_ARRAYS,), dtype=torch.int32, device=dev)
    append_case((pool,), owners, bases, zeros, elems, mask)
    item_bytes = 2 * KV_ITEM[0] * KV_ITEM[1]
    live = int(mask.sum().item())
    kv = {"append_ms": cuda_ms(lambda: k_pg.slab_append_cuda((pool,), owners, bases, zeros, elems, mask), 5),
          "append_plain_ms": cuda_ms(lambda: r_pg.slab_append(
              pool.reshape(S, B0, -1), owners, bases, zeros, elems.reshape(KV_ARRAYS, KV_MAX, -1), mask), 1),
          "append_bound_ms": bound_ms(mask.numel() * (1 + item_bytes + 4) + live * item_bytes, 0, card)[0],
          "append_shape": f"wave ({KV_ARRAYS}, {KV_MAX}, 8, 128) bf16, live {live}, pool {S} slabs"}
    k_pg.slab_append_cuda((pool,), owners, bases, zeros, elems, mask)
    del elems, mask
    torch.cuda.empty_cache()
    half = S // 2
    exts = (pool[:half].clone(), pool[half:].clone())
    del pool
    wide = torch.full((KV_ARRAYS, 16), -1, dtype=torch.int32, device=dev)
    wide[:, :pages.shape[1]] = pages
    gather_case(exts, wide)
    view_bytes = wide.numel() * B0 * item_bytes
    kv.update(view_ms=cuda_ms(lambda: k_pg.paged_gather_cuda(exts, wide, clip_high=False), 3),
              view_plain_ms=cuda_ms(lambda: r_pg.gather_pages_extents(
                  tuple(e.reshape(e.shape[0], B0, -1) for e in exts), wide), 1),
              view_bound_ms=bound_ms(S * B0 * item_bytes + view_bytes, 0, card)[0],
              view_shape=f"pages ({KV_ARRAYS}, 16), {S} live, 2 extents, out {view_bytes} bytes")
    timing["slab_append"]["extra"] = kv
    del exts, wide, owners, bases, pages
    torch.cuda.empty_cache()


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
    for name in SLICE1_KERNELS:
        check(launches[name] >= 1, f"kernel {name} never launched on the main path")
    return launches


# --------------------------------------------------------------------------
# Phase 5: the arena's paths (slab arena, KV-shaped arena, packer).
# --------------------------------------------------------------------------


def check_arena_frozen(pipe, per_block, what: str) -> int:
    """The frozen view against numpy: each array's live lanes in order,
    arrays concatenated, zeros after, and the block_starts table."""
    import numpy as np
    import torch

    frozen = pipe.frozen
    want = np.concatenate([np.concatenate(c) if c else np.zeros(0, np.float32) for c in per_block])
    n = int(frozen.size.item())
    check(n == want.size, f"{what}: size {n} != {want.size}")
    got = frozen.data[:n].cpu().numpy()
    check(np.array_equal(got.view(np.uint32), want.view(np.uint32)), f"{what}: data[:n] differs")
    check(int(torch.count_nonzero(frozen.data[n:].view(torch.int32)).item()) == 0,
          f"{what}: data[n:] not 0")
    counts = np.asarray([sum(x.size for x in c) for c in per_block])
    check(np.array_equal(frozen.block_starts.cpu().numpy(), np.cumsum(counts) - counts),
          f"{what}: block_starts differ")
    return n


def check_arena_bounds(arena, peak_live: int, what: str) -> dict:
    """check_invariants() (every slab free or held by exactly one array,
    device and host state agree) and the capacity bounds: claimed slabs hold
    at most one partial slab per array beyond the peak live elements, and
    over-provisioned growth at most doubles that."""
    stats = arena.check_invariants()
    T, n = arena.slab_size, arena.narrays
    check(stats["live_slabs"] * T <= peak_live + T * n,
          f"{what}: claimed capacity exceeds peak live + one slab per array")
    check(stats["capacity_tokens"] <= 2 * (peak_live + T * n),
          f"{what}: capacity exceeds 2 (peak live + one slab per array)")
    return stats


def arena_path(card: str, rng, gen, slab: int, grow_chunk: str, what: str) -> dict:
    """grow -> freeze -> read -> release every 4th array -> reuse wave ->
    refreeze on a 512-array arena; then (extent layouts) the steady state."""
    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.pool import SlabArena
    from repro_torch.runtime import TwoPhasePipeline

    common.reset_launch_counts()
    arena = SlabArena(NBLOCKS, slab, dtype=torch.float32, grow_chunk=grow_chunk, device=DEV)
    pipe = TwoPhasePipeline.from_arena(arena)
    waves, t_grow = grow(pipe, rng, slab, "auto", card)
    per_block = [[v[b][m[b]] for v, m in waves] for b in range(NBLOCKS)]
    del waves
    t0 = time.perf_counter()
    pipe.freeze()
    t_freeze = time.perf_counter() - t0
    n = check_arena_frozen(pipe, per_block, f"{what} freeze")
    idx = torch.randint(0, n, (1 << 24,), generator=gen, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pipe.read(idx)
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    want = np.concatenate([np.concatenate(c) for c in per_block])[idx.cpu().numpy()]
    check(np.array_equal(got.cpu().numpy().view(np.uint32), want.view(np.uint32)), f"{what}: reads differ")
    del got, want, idx
    peak_live = n
    check_arena_bounds(arena, peak_live, f"{what} grown")
    grow_events, extents = arena.pool_grow_events, arena.pool.n_extents

    # release every 4th array, then one wave that the freed slabs cover
    pipe.thaw()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    freed = sum(arena.release(b) for b in range(0, NBLOCKS, 4))
    torch.cuda.synchronize()
    t_release = time.perf_counter() - t0
    for b in range(0, NBLOCKS, 4):
        per_block[b] = []
    reuse_before, grown_before = arena.alloc.reuse_claims, arena.alloc.grown_slabs
    m = slab << max(NWAVES - 4, 0)  # needs about a quarter of the slabs freed
    vals = rng.standard_normal((NBLOCKS, m), dtype=np.float32)
    mask = rng.random((NBLOCKS, m), dtype=np.float32) < 0.9
    dev_vals = torch.from_numpy(vals).to(DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.append(dev_vals, mask)
    torch.cuda.synchronize()
    t_reuse = time.perf_counter() - t0
    del dev_vals
    for b in range(NBLOCKS):
        per_block[b].append(vals[b][mask[b]])
    check(arena.pool_grow_events == grow_events and arena.alloc.grown_slabs == grown_before,
          f"{what}: the pool grew although freed slabs covered the wave")
    reused = arena.alloc.reuse_claims - reuse_before
    check(reused > 0, f"{what}: freed slabs were not reused")
    live_now = sum(sum(x.size for x in c) for c in per_block)
    peak_live = max(peak_live, live_now)
    stats = check_arena_bounds(arena, peak_live, f"{what} reuse")
    if grow_chunk in ("doubling", "tz"):
        check(arena.pool_copied_bytes == 0, f"{what}: extent growth copied pool bytes")
    t0 = time.perf_counter()
    pipe.freeze()
    t_refreeze = time.perf_counter() - t0
    n2 = check_arena_frozen(pipe, per_block, f"{what} refreeze")
    if grow_chunk in ("doubling", "tz"):
        check(arena.pool_copied_bytes == 0, f"{what}: extent growth copied pool bytes")
    emit({"phase": f"arena.{what}", "card": card, "narrays": NBLOCKS, "slab_size": slab,
          "grow_chunk": grow_chunk, "elements": n, "capacity_tokens": stats["capacity_tokens"],
          "extents": extents, "grow_events": grow_events, "grow_s": t_grow, "freeze_s": t_freeze,
          "read_s": t_read, "reads": 1 << 24, "released_slabs": freed, "release_s": t_release,
          "reuse_claims": reused, "reuse_wave_s": t_reuse, "refreeze_s": t_refreeze,
          "elements_after_reuse": n2, "copied_bytes": arena.pool_copied_bytes,
          "host_syncs": arena.host_syncs, "ok": True})

    steady = None
    if grow_chunk in ("doubling", "tz"):
        # steady state: appends that fit the claimed pages, host masks, no
        # device read allowed (torch raises on any synchronising call)
        pipe.thaw()
        room = arena.book.npages * slab - arena.planner.ub
        k = np.minimum(STEADY_M, room // STEADY_WAVES)
        mask = np.arange(STEADY_M)[None, :] < k[:, None]
        dwaves = [torch.randn((NBLOCKS, STEADY_M), generator=gen, device=DEV)
                  for _ in range(STEADY_WAVES)]
        syncs, claims = arena.host_syncs, arena.alloc.claims
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for v in dwaves:
                pipe.append(v, mask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(arena.host_syncs == syncs, f"{what}: steady-state appends made a planner host sync")
        check(arena.alloc.claims == claims, f"{what}: steady-state appends claimed slabs")
        check(pipe.total_size() == n2 + STEADY_WAVES * int(mask.sum()),
              f"{what}: steady-state appends lost elements")
        steady = {"appends": STEADY_WAVES, "m": STEADY_M, "host_syncs_added": 0,
                  "lanes": STEADY_WAVES * int(mask.sum())}
        emit({"phase": f"arena.{what}.steady", "card": card, **steady, "ok": True})
    del pipe, arena, per_block
    torch.cuda.synchronize()
    return common.launch_counts()


def kv_path(card: str, rng, gen) -> dict:
    """The KV-shaped arena: one ragged prefill wave, 32 decode waves, then
    the logical view and the flatten against numpy, bitwise."""
    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.pool import SlabArena

    common.reset_launch_counts()
    arena = SlabArena(KV_ARRAYS, B0, item_shape=KV_ITEM, dtype=torch.bfloat16,
                      grow_chunk="doubling", device=DEV)
    lens = rng.integers(KV_MIN, KV_MAX + 1, KV_ARRAYS)
    lens[0] = B0 - KV_DECODE // 2  # its decode steps cross into a new slab: the pool grows
    mask = np.arange(KV_MAX)[None, :] < lens[:, None]
    prefill = torch.randn((KV_ARRAYS, KV_MAX, *KV_ITEM), generator=gen, device=DEV,
                          dtype=torch.bfloat16)
    decode = torch.randn((KV_DECODE, KV_ARRAYS, 1, *KV_ITEM), generator=gen, device=DEV,
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pos = arena.append(prefill, mask)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    want_pos = np.where(mask, np.arange(KV_MAX)[None, :], -1)
    check(np.array_equal(pos.cpu().numpy(), want_pos), "kv: prefill positions differ")
    ones = np.ones((KV_ARRAYS, 1), bool)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(KV_DECODE):
        arena.append(decode[t], ones)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    pre_np = prefill.view(torch.int16).cpu().numpy()
    dec_np = decode.view(torch.int16).cpu().numpy()
    del prefill, decode
    want = [np.concatenate([pre_np[i, :lens[i]], dec_np[:, i, 0]]) for i in range(KV_ARRAYS)]
    del pre_np, dec_np
    view = arena.logical_view()
    check(tuple(view.shape) == (KV_ARRAYS, arena.arr.max_pages * B0, *KV_ITEM), "kv: view shape")
    for i in range(KV_ARRAYS):
        n_i = len(want[i])
        row = view[i].view(torch.int16)
        check(np.array_equal(row[:n_i].cpu().numpy(), want[i]), f"kv: view of array {i} differs")
        check(int(torch.count_nonzero(row[n_i:]).item()) == 0, f"kv: view of array {i} not 0 past its size")
    view_elems = view.numel()
    del view, row
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat, total, starts = arena.flatten()
    torch.cuda.synchronize()
    t_flatten = time.perf_counter() - t0
    n = int(total.item())
    check(n == sum(len(w) for w in want), "kv: flatten size")
    starts_np = starts.cpu().numpy()
    bits16 = flat.view(torch.int16)
    for i in range(KV_ARRAYS):
        s0 = int(starts_np[i])
        check(np.array_equal(bits16[s0:s0 + len(want[i])].cpu().numpy(), want[i]),
              f"kv: flatten of array {i} differs")
    check(int(torch.count_nonzero(bits16[n:]).item()) == 0, "kv: flatten not 0 past its size")
    del flat, bits16
    stats = check_arena_bounds(arena, n, "kv")
    check(arena.pool_copied_bytes == 0, "kv: extent growth copied pool bytes")
    emit({"phase": "arena.kv", "card": card, "narrays": KV_ARRAYS, "slab_size": B0,
          "item": list(KV_ITEM), "dtype": "bfloat16", "prefill_tokens": int(lens.sum()),
          "decode_waves": KV_DECODE, "elements": n, "view_elements": view_elems,
          "capacity_tokens": stats["capacity_tokens"], "extents": arena.pool.n_extents,
          "prefill_append_s": t_prefill, "decode_appends_s": t_decode, "flatten_s": t_flatten,
          "host_syncs": arena.host_syncs, "ok": True})
    del arena
    torch.cuda.synchronize()
    return common.launch_counts()


def packer_path(card: str, rng) -> dict:
    """Packer(backend="arena") against Packer(backend="pipeline"): the same
    documents must give identical packs; the arena ingests with no host sync."""
    import numpy as np
    import torch

    from repro_torch.data import Packer
    from repro_torch.kernels import common

    common.reset_launch_counts()
    docs = [rng.integers(1, 151_000, int(rng.integers(PACK_MIN, PACK_MAX + 1))).astype(np.int32)
            for _ in range(PACK_DOCS)]
    total = sum(len(d) for d in docs)
    seq = 8192
    batch = -(-total // seq)
    outs, times = {}, {}
    for backend in ("pipeline", "arena"):
        p = Packer(nblocks=PACK_BLOCKS, b0=B0, backend=backend, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for d in docs:
            p.add_document(d)
        torch.cuda.synchronize()
        times[f"{backend}_ingest_s"] = time.perf_counter() - t0
        check(p.total_tokens == total, f"packer {backend}: tokens lost")
        t0 = time.perf_counter()
        outs[backend] = p.pack(batch=batch, seq=seq)
        times[f"{backend}_pack_s"] = time.perf_counter() - t0
        times[f"{backend}_host_syncs"] = p.stats.host_syncs
        del p
    check(torch.equal(outs["pipeline"]["tokens"], outs["arena"]["tokens"]), "packer: tokens differ")
    check(torch.equal(outs["pipeline"]["loss_mask"], outs["arena"]["loss_mask"]), "packer: masks differ")
    check(times["arena_host_syncs"] == 0, "packer: arena ingestion made host syncs")
    packed = outs["arena"]["tokens"][outs["arena"]["loss_mask"]].cpu().numpy()
    check(np.array_equal(np.sort(packed), np.sort(np.concatenate(docs))), "packer: token multiset differs")
    emit({"phase": "arena.packer", "card": card, "documents": PACK_DOCS, "tokens": total,
          "nblocks": PACK_BLOCKS, "b0": B0, **times, "ok": True})
    torch.cuda.synchronize()
    return common.launch_counts()


def arena_paths(card: str, seed: int) -> dict:
    """Every arena path, launch counts zeroed before each and read after →
    the counts summed over the paths."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 100)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 101)
    torch.cuda.reset_peak_memory_stats()
    runs = {
        "doubling": arena_path(card, rng, gen, B0, "doubling", "doubling"),
        "geometric": arena_path(card, rng, gen, B0 // 8, "geometric", "geometric"),
        "kv": kv_path(card, rng, gen),
        "packer": packer_path(card, rng),
    }
    # the kernels each path must have launched
    need = {"doubling": ("slab_append", "paged_gather_extents", "segmented_gather"),
            "geometric": ("slab_append", "paged_gather", "segmented_gather"),
            "kv": ("slab_append", "paged_gather_extents"),
            "packer": ("slab_append", "paged_gather", "segmented_gather", "compact_blocks")}
    for path, names in need.items():
        for name in names:
            check(runs[path][name] >= 1, f"kernel {name} never launched on the {path} arena path")
    emit({"phase": "arena.launches", "card": card, "launches": runs,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    total = {k: 0 for k in KERNELS}
    for counts in runs.values():
        for k, v in counts.items():
            total[k] += v
    return total


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
    torch.cuda.empty_cache()

    # 5. the arena's paths
    arena_launches = arena_paths(card, args.seed)
    launches = {k: launches[k] + arena_launches[k] for k in KERNELS}

    # 6. the kernels line
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": launches[name], "mismatches": res[name]["mismatches"],
         "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
         "plain_ms": res[name]["plain_ms"], "bound_ms": res[name]["bound_ms"],
         "bound_by": res[name]["bound_by"], "library_ms": res[name]["library_ms"],
         "shape": res[name]["shape"], "card": card}
        for name in KERNELS
    ]})
    # 7. the last line
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
