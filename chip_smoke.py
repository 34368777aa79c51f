#!/usr/bin/env python3
"""Build the PyTorch/CUDA port and drive it on one CUDA card.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --ab PARENT [--what prefill,paged,batch,append,freeze]   # two checkouts, in turns

Run from the root of the repository.  Phases, one JSON line each:

1. device — the card's name and power limit (``nvidia-smi``); TF32 off.
2. build — every ``src/repro_torch/csrc/*.cu`` compiled by ``nvcc``.
3. kernels — K1 (row scan), K3 (push-back, one group and the KV cache's
   two), K6 (compaction), K7 (segmented gather, from the plane and from
   the bucket levels; the levels form also timed beside K6 then K7 on the
   plane, a ``kernel.levels`` line), K8/K9 (paged gather, one
   extent / many) and K12 (slab append) against their plain PyTorch
   versions, bitwise; K13 (flash prefill) within the reference tests'
   attention tolerances and K10/K11 (paged decode attention) within 1e-4
   (``ATTEND_TOL``, abs + rel, every pool dtype); at small
   ragged shapes (three payload types, scalar and (8, 128) items, flat /
   doubling / tz extents, page -1, fuzzed owner tables) and at the main
   paths' shapes, with the kernel's, the plain version's and (where one
   exists) a library call's times and the bound (bytes, or bf16 flops for K13).
   K13 also at the edges of its 64- and 128-row tiles (lengths 63, 65, 127,
   129 and 1000; bf16, f16 and f32; causal and not; both layouts), with
   Sq < Skv, two launches at the serving shape bitwise equal, and a bf16
   view off the 16-byte grid refused; timed in a CUDA graph.
   K2 (tensor-core scan) bitwise on int32 masks and full-range int32, f32
   within rtol 1e-3 / atol 1e-4, also at the edges of its chained tiles
   (``freeze_edge_cases``: cols 1, 31, 32, 33 and around and past the tile
   width, rows 1 and no multiple of 16, a status-buffer growth refused
   under a CUDA-graph capture, 20 replays then an eager launch bitwise
   equal in int32 and f32, the status words and ticket left zero), and K7
   in both forms, counted and uncounted, at the edges of its ranges (many
   owners a range, empty blocks at range edges, gaps, live items past cap,
   cap = 1, ragged tails, 2-byte items, odd starts); K5a (dispatch) and K5b (combine) bitwise
   with unique positions, up to the freeze's 2.7e8 lanes (repeated
   positions: int32 bitwise, floats within 1e-5 / 2e-2); K14 (flash-decode)
   within 2 ulps (bf16) / 256 ulps (f32) of the output's largest magnitude,
   head-major and token-major, lengths 0, inside and at S, the dead tail,
   lengths 1, nsplit - 1, nsplit and nsplit + 1 at odd and even split
   counts, B * KH past the ticket buffer's first size, a launch that would
   grow the buffer inside a CUDA-graph capture refused, 20 CUDA-graph
   replays then an eager launch bitwise equal to the one before them, and
   the serving shape.
   K8/K9 also at the edges of the gather's plan (N·P pages no multiple of a
   block's 512 pieces, a single page, 4-, 2- and 1-byte pieces, slabs that
   straddle blocks, 4 MB slabs, page -1 and ids past the pool, flat and
   extents), counted and uncounted, bitwise, with the counters
   ``ref.gather_counters``; K8 and its ``index_select`` timed in CUDA-graph
   replays (one call from Python beside them).
   K10/K11 also at the edges of the split by the live length (lengths 0, 1,
   nsplit - 1, nsplit, nsplit + 1, at a page's end, a hole straddling a
   split boundary, ids past the pool clipped or skipped; G 1, 4, 8, 16; D
   16, 32, 64, 128; f32, bf16 and f16 pools), counted and uncounted, the
   counters ``ref.attend_counters``; B * KH past the ticket buffer's first
   size, a launch that would grow its buffers inside a CUDA-graph capture
   refused, 20 replays then an eager launch bitwise equal to the one
   before them, the tickets left zero.
   K3 and K12 also at the edges of their tile-parallel row scan
   (``append_edge_cases``, a generator of its own): m at a tile's edges and
   over many tiles, all-masked and all-live rows, 16-, 4-, 2- (and for K12
   1-) byte copy units over f32, int32, bf16 and f16; K3 counted and
   uncounted (counters ``ref.counters``), on sizes at level boundaries,
   waves past the last level and m = 1 with one to four groups of mixed
   items; K12 on fuzzed and arena-built owner tables with lanes past every
   slab and a sparse mask; all bitwise.  The two-group K3 is timed beside
   an empty kernel of its grid in the same CUDA-graph harness (the launch
   floor, in its shape string).
   ``--ab PARENT``: one process per turn, importing the package of the
   checkout at PARENT or this one's (each builds its own kernels), in turns
   (parent, change, change, parent), timing what ``--what`` names:
   ``prefill`` (serve.engine's prefill, then profiled: device time by
   kernel), ``paged`` (K8, K9 and the KV view beside ``index_select``,
   K10/K11 at the serving shape in CUDA-graph replays; each with and
   without counters; the kernel phase's input builders), ``batch``
   (BatchEngine's steady decode steps) and ``append`` (K12 at the main and
   KV shapes, K3 at the main shape and at the decode append in CUDA-graph
   replays and from Python, with and without counters; the main path's
   and arena.doubling's grow; a few Engine decode steps) and ``freeze``
   (K2 on the last grow wave from Python and in CUDA-graph replays, K7 on
   the freeze's plane with and without counters, ``flatten_segmented`` at
   the main shape with its kernels' device times, main.freeze's and
   main.mxu's grow and freeze).
4. main path — ``TwoPhasePipeline(nblocks=512, b0=2048)`` grown by eight
   doubling waves to about 2.4e8 float32 elements, frozen (K7 reading the
   levels; no K6 launch, which the path checks), read at 2^24
   random indices and checked bitwise against a numpy expectation; thawed,
   grown by one more wave, refrozen and checked again; the same at one
   eighth of the size with ``method="tile"``; then 16 steady-state appends
   under ``torch.cuda.set_sync_debug_mode("error")``.
   ``main.mxu``: the same grow with ``method="mxu"`` (K2), frozen by the
   segmented gather and checked, frozen again with ``flatten_impl=
   "dispatch"`` (K6 + K5a) and held bitwise against it (after adding +0.0:
   the dispatch's scatter-add turns a -0.0 into +0.0, as the reference's
   does); after the path's launch counts are read, the frozen array is read
   back into the block-major plane through ``combine`` (K5b, which no path
   of the reference calls) as a check.  ``baselines``: the same
   eight waves into a static array sized for the end, a semi-static array
   grown by realloc, one with memMap accounting and a GGArray, under the
   insertion methods scan, tile (K1) and mxu (K2): per wave insert and
   resize ms, allocated over live and copied bytes; contents checked.
   ``lfvector``: one LFVector (b0 2048) pushed to 2^22 elements.
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
6. serving — qwen2.5-3b at full width with random bf16 weights and the
   reference's TPU-kernel settings (``attention_impl="pallas"``,
   ``paged_attend_impl="pallas"``).  ``serve.engine``: ``Engine(policy=
   "ggarray")`` on 4 prompts of 256-1792 tokens (padded to 1792) and 320
   new tokens — one growth, no bytes copied, one host sync; prefill, TTFT,
   decode steps under the sync check.  ``serve.batch.doubling`` and
   ``serve.batch.1``: ``BatchEngine`` with 8 slots and 16 (12) requests of
   512-4096 tokens, 64 new, chunked admission, over doubling extents (K11)
   and a flat pool grown by realloc (K10); free list, pool bound, reuse,
   copied bytes, two host syncs, steady decode steps under the sync check.
   ``serve.cross_check``: Engine's last-position prefill logits (K13) against
   BatchEngine's (chunked prefill).  ``serve.captured``: K13, K3 (two
   groups), K10/K11 against their plain versions on layer-0 inputs captured
   from those runs.  ``serve.policies``: Engine under ``static``,
   ``semistatic`` and ``two_phase`` on the same prompts, 272 new tokens
   (one growth for the growing policies): TTFT, decode steps under the sync
   check, grow/freeze events, copied and allocated bytes, one host sync;
   the K/V written before the growth bitwise equal to ggarray's (the
   realloc copy, thaw → grow → refreeze), first-step logits bitwise equal
   to ggarray's (static: relative L2 <= 3e-2), the first step after the
   growth within relative L2 3e-2; after the path's launch counts are read,
   K14 (which no path of the reference calls) through its op on layer 0's
   captured contiguous cache, held against its plain version and
   ``kvcache.attend``.
6b. the remaining model families, full width, random bf16 weights.
   ``moe.route``: one dbrx-132b MoE layer (d_model 6144, 16 experts, top-4,
   d_ff_expert 10752) on 4 x 1792 tokens under the insertion methods
   ``scan``, ``tile`` (K1) and ``mxu`` (K2), and at an 8-slot decode step
   (16 x 32 lanes) under those and ``atomic``: offsets, slots, packed
   buffers and layer outputs bitwise equal across methods, K1 and K2
   bitwise their plain versions on the assignment masks; K1, K2 and
   ``torch.cumsum`` timed there in CUDA-graph replays, tokens dropped,
   routing's time in the layer.  ``serve.moe``: dbrx-132b
   cut to 8 layers, ``insertion_method="mxu"``: Engine(ggarray) on
   serve.engine's prompt lengths with 320 new tokens (one growth, no bytes
   copied), BatchEngine (chunked, doubling) on 16 requests; K2, K3, K10 or
   K11 and K13 each launched (BatchEngine's K/V writes are plain scatters
   in both packages: K12 is the arena's); routing's share of a steady
   decode step.  ``serve.hybrid``: jamba-v0.1-52b whole: Engine on 4 x
   1792, 64 new; BatchEngine on 16 ragged requests; the two prefills'
   logits on the equal prompts.  ``serve.ssm``: mamba2-2.7b whole, Engine
   on 4 x 1792, 64 new.  ``serve.encdec``: seamless-m4t-large-v2 whole:
   ``encode`` on 4 x 1024 synthetic frames, prefill with that memory, 32
   decode steps.  ``serve.vlm``: internvl2-26b at full width cut to 4
   layers, 256 prefix embeddings before 1536 tokens, 32 decode steps.  The
   last three hold the last decode step's logits against ``forward`` over
   the whole sequence.  Those equivalence checks run the same model again
   in f32 (8 decode steps) within relative L2 2e-3 (``FAMILY_TOL``): in
   bf16, rounding alone moves Jamba's logits by about 0.12 between two
   GEMM batchings, so the bf16 gaps are printed, not gated.  Every decode
   step runs under the sync check; K13 and the two-group K3 (Engine) and
   K10/K11 (BatchEngine) on the captured layer-0 inputs against their
   plain versions.
7. the device counter plane (K15).  ``obs.kernels`` (after the kernel
   phase): K3 (one group at the main path's last wave, two groups at
   m = 1, small ragged waves, empty masks), K7 (the freeze's plane, empty
   blocks, ragged tail tiles), K8/K9 (the freezes' gathers, page -1 and
   ids past the pool) and K10/K11 (the serving shape, lengths 0 and holes),
   each launched with and without counters: data outputs bitwise equal,
   the counter vector bitwise equal to the plain twin's (``ref.py``), both
   times (plain, counted, counted, plain) and the overhead.  ``obs.arena``
   (after the arena paths): ``SlabArena(instrument=True)`` at
   arena.doubling's size, its counters equal to the sum of its waves'
   oracle vectors; a small arena with a refcount broken on purpose writes
   exactly one flight-recorder bundle that names the slab and reads back
   through ``repro_torch.obs.dump``.  ``obs.serve`` (after serve.policies):
   ``Engine`` on serve.engine's prompts and ``BatchEngine`` on
   serve.batch.1's requests, 32 new tokens, without and with
   ``instrument=True``: the same tokens, K3 waves, slab-append waves and
   ``paged_attend.launches`` equal to the steps times the layers, decode
   steps under the sync check, median steps of both.
8. kernels — one line listing every ported kernel and ``counter_plane``
   (its launches: the instrumented launches of every path; its times: K3's
   at the main shape with and without counters).
9. the last line: ``{"ok": true, "device": {...}}``.

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
# Dense bf16 tensor-core peak of an H100 SXM (NVIDIA's data sheet): the
# bound of attention's products, whatever the kernel computes them with.
PEAK_BF16_FLOPS = 989e12

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
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:67"),
    "paged_attend": ("src/repro_torch/csrc/paged_attend.cu",
                     "src/repro/kernels/paged/kernel.py:377"),
    "paged_attend_extents": ("src/repro_torch/csrc/paged_attend.cu",
                             "src/repro/kernels/paged/kernel.py:523"),
    "push_back_multi": ("src/repro_torch/csrc/push_back.cu",
                        "src/repro/kernels/push_back/kernel.py:255"),
    "row_scan_mxu": ("src/repro_torch/csrc/scan_mxu.cu",
                     "src/repro/kernels/scan_mxu/kernel.py:55"),
    "dispatch": ("src/repro_torch/csrc/dispatch.cu",
                 "src/repro/kernels/dispatch_mxu/kernel.py:89"),
    "combine": ("src/repro_torch/csrc/dispatch.cu",
                "src/repro/kernels/dispatch_mxu/kernel.py:116"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:64"),
    # K15: ctr_accum in every instrumented kernel (K3, K7, K8/K9, K10/K11)
    "counter_plane": ("src/repro_torch/csrc/common.cuh",
                      "src/repro/kernels/common.py:214"),
}

# The main path's kernels: its segmented freezes read the levels (K7's
# levels form), so K6 is not among them; main.mxu's dispatch freeze runs it.
SLICE1_KERNELS = ("row_scan", "push_back", "segmented_gather")

NBLOCKS, B0, NWAVES = 512, 2048, 8
STEADY_M, STEADY_WAVES = 64, 16
# The KV-shaped arena: one layer's K of qwen3-32b (n_kv_heads=8, d_head=128,
# src/repro/configs/qwen3_32b.py) in slabs of its default slab_tokens (2048,
# src/repro/configs/base.py), 64 sequences of 1024-16384 prefill tokens,
# then 32 decode steps.
KV_ARRAYS, KV_ITEM, KV_MIN, KV_MAX, KV_DECODE = 64, (8, 128), 1024, 16384, 32
PACK_DOCS, PACK_MIN, PACK_MAX, PACK_BLOCKS = 256, 512, 8192, 64
# Serving: qwen2.5-3b at full width (src/repro/configs/qwen25_3b.py: 36
# layers, d_model 2048, 16 heads over 2 KV heads of 128, d_ff 11008, vocab
# 151936, bf16), random weights from the seed.  Engine: 4 prompts of
# 256-1792 tokens (padded to 1792, a multiple of K13's 256 tile) and 320 new
# tokens, so the longest crosses cache_b0 = 2048 once.  BatchEngine: 8 slots,
# 16 requests of 512-4096 prompt tokens, 64 new tokens, 2048-token slabs.
SERVE_ARCH, SERVE_PROMPTS, SERVE_MIN, SERVE_LEN, SERVE_NEW, SERVE_SLAB = "qwen2.5-3b", 4, 256, 1792, 320, 2048
BATCH_SLOTS, BATCH_REQS, BATCH_MIN, BATCH_MAX, BATCH_NEW = 8, 16, 512, 4096, 64
# The flat (grow_chunk=1) BatchEngine run serves 12 requests (more than its 8
# slots, so freed slabs are reused): every growth there reallocates and
# copies the whole pool.
BATCH_REQS_FLAT = 12
# serve.policies: Engine under static / semistatic / two_phase on the
# serve.engine prompts; 272 new tokens take the longest (1792) past
# cache_b0 = 2048 after 256 decode steps, so each growing policy grows once.
POLICY_NEW = 272
# LFVector: one block, b0 = 2048, pushes of 2048 * 2^w (w = 0..10) and one
# more of 2048, to 2^22 elements.
LF_B0, LF_PUSHES = 2048, [2048 << w for w in range(11)] + [2048]
# obs.serve: the instrumented engines generate this many tokens (the
# serve.engine prompts, serve.batch.1's requests), with and without counters.
OBS_NEW = 32
OBS_ORDER = ("plain", "counted", "counted", "plain")
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


def bound_ms(nbytes: float, nops: float, name: str, peak_ops: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / peak_bytes_per_s(name) * 1e3
    t_ops = nops / peak_ops * 1e3
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


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: for calls whose Python wrapper takes longer than
    the kernel, ``cuda_ms`` would time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up: builds, extent tables, allocator pools
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
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
    from repro_torch.kernels.flatten import ops as fl_ops
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

    rand_payload = make_payload(gen)

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
        want = r_fl.gather_global(ca, starts, ends)
        # K7's two source forms: the plane, and the levels (the GGArray freeze)
        note("segmented_gather", [(k_fl.segmented_gather_cuda(ca, starts, ends), want),
                                  (k_fl.segmented_gather_levels_cuda(levels, b0, starts, ends), want),
                                  (fl_ops.flatten_segmented(levels, sizes, b0), want)])

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
    # (m = 2048 * 2^7) onto sizes where the seventh wave left them (k3_inputs).
    m_last = B0 << (NWAVES - 1)
    n_lev = NWAVES
    levels, elems, mask, sizes = k3_inputs(gen, rand_payload)
    written = tuple(x.clone() for x in levels)
    sa, pa = k_pb.push_back_cuda(written, sizes, B0, elems, mask)
    lb = tuple(x.clone() for x in levels)
    _, sb, pb_ = r_pb.push_back(lb, sizes, B0, elems, mask)
    note("push_back", [(sa, sb), (pa, pb_), *zip(written, lb)])
    del lb
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
    starts = indexing.block_starts(final_sizes)
    ends = starts + final_sizes
    n_live = int(final_sizes.sum().item())
    k7_bound = bound_ms(4 * n_live + 8 * NBLOCKS + plane_bytes,
                        NBLOCKS * cap * (NBLOCKS.bit_length()), card)
    timing["segmented_gather"] = dict(
        ms=cuda_ms(lambda: k_fl.segmented_gather_cuda(compact, starts, ends), 10),
        plain_ms=cuda_ms(lambda: r_fl.gather_global(compact, starts, ends), 2),
        library_ms=None,
        bound=k7_bound,
        shape=f"plane ({NBLOCKS}, {cap}) f32, {n_live} live",
    )
    # K7's levels form: the GGArray freeze, beside the K6 + K7 it replaces
    levels_ms = cuda_ms(lambda: k_fl.segmented_gather_levels_cuda(written, B0, starts, ends), 10)
    emit({"phase": "kernel.levels", "name": "segmented_gather", "card": card, "ms": levels_ms,
          "plain_ms": cuda_ms(lambda: r_fl.gather_levels(written, B0, starts, ends), 2),
          "k6_then_k7_ms": cuda_ms(lambda: k_fl.segmented_gather_cuda(
              k_fl.compact_blocks_cuda(written, B0), starts, ends), 10),
          "bound_ms": k7_bound[0], "bound_by": k7_bound[1],
          "shape": f"levels {n_lev} x ({NBLOCKS}, {B0}*2^b) f32, {n_live} live -> ({NBLOCKS * cap},)"})
    del compact, written
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
    append_edge_cases(card, note)
    torch.cuda.synchronize()
    serve_kernel_cases(card, res, timing)
    torch.cuda.synchronize()
    freeze_edge_cases(res)
    torch.cuda.synchronize()
    slice4_kernel_cases(card, res, timing)
    torch.cuda.synchronize()
    for name in KERNELS:
        if name == "counter_plane":  # held in obs.kernels
            continue
        r, t = res[name], timing[name]
        r.update(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"],
                 bound_ms=t["bound"][0], bound_by=t["bound"][1], shape=t["shape"])
        emit({"phase": "kernel", "name": name, "card": card, **r})
        if "extra" in t:
            emit({"phase": "kernel.kv", "name": name, "card": card, **t["extra"]})
        check(r["mismatches"] == 0, f"{name}: {r['mismatches']} elements differ from the plain version")
        check(r["cases"] > 0, f"{name}: never held against its plain version")
    return res


def k3_inputs(gen, payload):
    """K3's timed inputs: the main path's last grow wave (512 blocks, b0 =
    2048, 8 levels of f32, m = 2048 * 2^7 at 0.9 density) onto sizes where
    the seventh wave left them → (levels, elems, mask, sizes)."""
    import torch

    from repro_torch.core import indexing

    m_last = B0 << (NWAVES - 1)
    sizes = torch.full((NBLOCKS,), int(0.9 * B0 * (2 ** (NWAVES - 1) - 1)), dtype=torch.int32, device=DEV)
    sizes += torch.randint(-(B0 // 4), B0 // 4, (NBLOCKS,), generator=gen, device=DEV, dtype=torch.int32)
    levels = tuple(payload((NBLOCKS, w), torch.float32) for w in indexing.bucket_sizes(B0, NWAVES))
    elems = payload((NBLOCKS, m_last), torch.float32)
    mask = torch.rand((NBLOCKS, m_last), generator=gen, device=DEV) < 0.9
    return levels, elems, mask, sizes


def multi_inputs(gen, n, b0, nlev, m, item, p_live=1.0):
    """The two-group K3's inputs: k and v levels and waves of ``item`` bf16
    items and one mask → (groups, elems, mask)."""
    import torch

    from repro_torch.core import indexing

    def lv():
        return tuple(torch.randn((n, w, *item), generator=gen, device=DEV).to(torch.bfloat16)
                     for w in indexing.bucket_sizes(b0, nlev))

    groups = (lv(), lv())
    elems = tuple(torch.randn((n, m, *item), generator=gen, device=DEV).to(torch.bfloat16)
                  for _ in groups)
    mask = torch.rand((n, m), generator=gen, device=DEV) < p_live
    return groups, elems, mask


def decode_inputs(gen):
    """The Engine's decode append, K3's two-group timed shape: 4 sequences,
    m = 1, k and v items (2, 128) bf16 over the two levels of a cache grown
    once → (groups, sizes, elems, mask)."""
    import torch

    sizes = torch.randint(SERVE_SLAB, 2 * SERVE_SLAB, (SERVE_PROMPTS,), generator=gen, device=DEV,
                          dtype=torch.int32)
    groups, elems, mask = multi_inputs(gen, SERVE_PROMPTS, SERVE_SLAB, 2, 1, (2, 128))
    return groups, sizes, elems, mask


def make_payload(gen):
    """→ payload(shape, dtype): random data drawn from ``gen`` (int32 in
    [-1000, 1000), floats normal)."""
    import torch

    def payload(shape, dtype):
        if dtype == torch.int32:
            return torch.randint(-1000, 1000, shape, generator=gen, device=DEV, dtype=dtype)
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    return payload


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

    # Main-path shapes.  K12: the scalar arena's last grow wave; K9: the
    # freeze's gather of that arena (k12_inputs).
    exts, owners, bases, sizes, elems, mask, pages = k12_inputs(gen, payload)
    m_last, S = mask.shape[1], sum(e.shape[0] for e in exts)
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

    # K8 (k8_inputs).  Its device time and index_select's from CUDA-graph
    # replays: a call from Python (in the shape string) adds the wrapper's
    # host time to the first of its launches, a few per cent of this one.
    pool, pages = k8_inputs(gen, payload)
    S, t8 = pool.shape
    gather_case((pool,), pages)
    n_live_pages = int((pages >= 0).sum().item())
    idx = pages.clamp(min=0).flatten().long()
    timing["paged_gather"] = dict(
        ms=graph_ms(lambda: k_pg.paged_gather_cuda((pool,), pages, clip_high=True), 20),
        plain_ms=cuda_ms(lambda: r_pg.gather_pages(pool[:, :, None], pages), 5),
        library_ms=graph_ms(lambda: pool.index_select(0, idx), 20),
        bound=bound_ms(n_live_pages * t8 * 4 + pages.numel() * 4 + pages.numel() * t8 * 4, 0, card),
        shape=f"pages ({NBLOCKS}, {pages.shape[1]}), {n_live_pages} live, flat pool {S} x {t8} f32; "
              f"CUDA-graph times; one call from Python "
              f"{cuda_ms(lambda: k_pg.paged_gather_cuda((pool,), pages, clip_high=True), 20)} ms, "
              f"index_select's {cuda_ms(lambda: pool.index_select(0, idx), 20)} ms",
    )
    del pool, pages, idx
    torch.cuda.empty_cache()

    # KV-shaped: the prefill wave (K12 on one extent) and the logical view
    # after the decode steps (K9 over two extents) (kv_inputs, kv_view).
    pool, owners, bases, zeros, elems, mask, pages = kv_inputs(gen, payload)
    S = pool.shape[0]
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
    exts, wide = kv_view(pool, pages)
    del pool
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
    gather_edge_cases(note)


def append_edge_cases(card: str, note) -> None:
    """K3 and K12 at the edges of the tile-parallel row scan and of their
    copies, each held bitwise against its plain version (K3 counted and
    uncounted, its counters equal to ``ref.counters``), from a generator of
    their own: m at a tile's edges (tile - 1, tile, tile + 1) and over many
    tiles, all-masked and all-live rows, f32 / int32 / bf16 / f16 payloads
    in 16-, 4- and 2-byte copy units (and 1-byte for K12's byte items; K3
    takes no 1-byte payload); K3 on sizes at a level boundary and waves past
    the last level, and at m = 1 with one to four groups of mixed item
    sizes; K12 on fuzzed owner tables (owner -1, owners past N, overlapping
    windows, misaligned bases), arena tables whose claimed slabs end inside
    the wave, and a sparse mask whose slab windows span many tiles."""
    import torch

    from repro_torch.core import indexing
    from repro_torch.kernels import common
    from repro_torch.kernels.paged import kernel as k_pg
    from repro_torch.kernels.paged import ref as r_pg
    from repro_torch.kernels.push_back import kernel as k_pb
    from repro_torch.kernels.push_back import ref as r_pb
    from repro_torch.obs import device as obs_device

    dev = torch.device(DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(19)
    payload = make_payload(gen)

    def payload8(shape, dtype):
        if dtype == torch.uint8:
            return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=dtype)
        return payload(shape, dtype)

    def item_bytes(t, lead):
        n = t.element_size()
        for d in t.shape[lead:]:
            n *= d
        return n

    seen = {"push_back_cases": 0, "slab_append_cases": 0, "k3_plans": set(), "k12_plans": set(),
            "k3_units": set(), "k12_units": set()}

    def k3(n, b0, nlev, m, groups, p_live, sizes=None):
        """groups: ((item, dtype), ...) sharing one mask."""
        cap = indexing.capacity(b0, nlev)
        if sizes is None:
            sizes = torch.randint(0, cap + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
        levels = tuple(tuple(payload((n, w, *it), dt) for w in indexing.bucket_sizes(b0, nlev))
                       for it, dt in groups)
        elems = tuple(payload((n, m, *it), dt) for it, dt in groups)
        mask = torch.rand((n, m), generator=gen, device=dev) < p_live
        a, b = clone_tree(levels), clone_tree(levels)
        sa, pa = k_pb.push_back_cuda_multi(a, sizes, b0, elems, mask)
        sb, pb_, blk = k_pb.push_back_cuda_multi(b, sizes, b0, elems, mask, instrument=True)
        pairs = []
        for g, (lv, e) in enumerate(zip(levels, elems)):
            want = clone_tree(lv)
            _, ws, wp = r_pb.push_back(want, sizes, b0, e, mask)
            pairs += [*zip(a[g], want), *zip(b[g], want), (sa, ws), (pa, wp), (sb, ws), (pb_, wp)]
        pairs.append((obs_device.from_block(blk), r_pb.counters(mask, sizes, b0, nlev)))
        note("push_back" if len(groups) == 1 else "push_back_multi", pairs)
        unit = [common.copy_unit(item_bytes(e, 2), e, *lv) for e, lv in zip(elems, levels)]
        seen["k3_plans"].add(tuple(k_pb.push_back_plan(m, sum(item_bytes(e, 2) // u for e, u in zip(elems, unit)))))
        seen["k3_units"].update(unit)
        seen["push_back_cases"] += 1

    f32, i32, bf16, f16 = torch.float32, torch.int32, torch.bfloat16, torch.float16
    tile = 256 * common.SCAN_PER  # K3's tile at m > 64 lanes of one unit
    for m in (tile - 1, tile, tile + 1, 3 * tile + 5, 40_000):
        for p_live in (0.6, 0.0, 1.0):
            k3(3, 8, 12, m, [((), f32)], p_live)
    # sizes at a level's first and last slot and past the capacity; a wave
    # that runs past the last level
    b0, nlev = 16, 6
    starts = indexing.bucket_starts(b0, nlev)
    cap = indexing.capacity(b0, nlev)
    edge = [starts[2], starts[2] - 1, starts[4], starts[5] - 1, cap - 3, cap, cap + 7]
    sizes = torch.tensor(edge, dtype=torch.int32, device=dev)
    for m in (1, 40, tile + 1):
        k3(len(edge), b0, nlev, m, [((), i32)], 0.9, sizes)
        k3(len(edge), b0, nlev, m, [((2, 8), bf16), ((3,), f32)], 1.0, sizes)
    # m = 1 with one to four groups of mixed items: 16-byte (512 B bf16),
    # 4-byte (12 B f32) and 2-byte (10 B f16) units, and int32 scalars
    mixed = [((2, 128), bf16), ((3,), f32), ((5,), f16), ((), i32)]
    for ng in range(1, 5):
        for n in (1, 4, 37):
            k3(n, SERVE_SLAB // 64, 3, 1, mixed[:ng], 1.0)
            k3(n, 4, 3, 1, mixed[:ng][::-1], 0.5)
    for it, dt in mixed + [((2, 128), f16), ((2, 8), f32)]:
        k3(5, 4, 9, 130, [(it, dt)], 0.6)
    # 128-thread blocks: 96 and 128 16-byte units a row
    k3(4, 8, 3, 1, [((2, 128), bf16)] * 3, 1.0)
    k3(4, 8, 3, 2, [((2, 128), bf16)] * 2, 0.5)

    def k12(N, T, m, item, dtype, mask, owners, bases, sizes, layout="flat"):
        S = owners.shape[0]
        sizes_e = _extent_sizes(S, layout)
        total = sum(sizes_e)
        if total > S:  # the layout's extra slabs are free
            owners = torch.cat([owners, torch.full((total - S,), -1, dtype=torch.int32, device=dev)])
            bases = torch.cat([bases, torch.zeros((total - S,), dtype=torch.int32, device=dev)])
        exts = _split(payload8((total, T, *item), dtype), sizes_e)
        elems = payload8((N, m, *item), dtype)
        work = clone_tree(exts)
        ns, pos = k_pg.slab_append_cuda(work, owners, bases, sizes, elems, mask)
        flat = torch.cat([e.reshape(e.shape[0], T, -1) for e in exts])
        want_pool, want_sizes, want_pos = r_pg.slab_append(flat, owners, bases, sizes,
                                                           elems.reshape(N, m, -1), mask)
        got_pool = torch.cat([w.reshape(w.shape[0], T, -1) for w in work])
        note("slab_append", [(got_pool, want_pool), (ns, want_sizes), (pos, want_pos)])
        ib = item_bytes(elems, 2)
        seen["k12_plans"].add(tuple(k_pg.append_plan(m, ib, T)))
        seen["k12_units"].add(common.copy_unit(ib, elems, *work))
        seen["slab_append_cases"] += 1

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    def covering(N, T, m, mask, sizes, short=0):
        """Arena tables whose claimed slabs cover each array's wave, less
        ``short`` slabs (its last live lanes then land past every slab)."""
        after = (sizes + mask.sum(1, dtype=torch.int32)).cpu().tolist()
        npages = [max(-(-a // T) - short, 0) for a in after]
        owners, bases, _ = _arena_tables(npages, sum(npages) + 3, T, gen)
        return owners, bases

    # the scan pass's tile edges (64 threads up to 1024 lanes, 128 to 2048,
    # 256 above: tiles of 1024, 2048 and 4096 lanes) and many tiles
    N, T = 3, 64
    for m in (1023, 1024, 1025, 2048, 2049, 4095, 4096, 4097, 20_000):
        for p_live in (0.7, 0.0, 1.0):
            mask = torch.rand((N, m), generator=gen, device=dev) < p_live
            sizes = ints(0, 3 * T, (N,))
            owners, bases = covering(N, T, m, mask, sizes, short=1 if p_live == 0.7 else 0)
            k12(N, T, m, (), torch.float32, mask, owners, bases, sizes, "doubling" if m % 2 else "flat")
    # a sparse mask: each 128-slot window spans about eight 4096-lane tiles
    m = 60_000
    mask = torch.rand((N, m), generator=gen, device=dev) < 0.004
    sizes = ints(0, 300, (N,))
    owners, bases = covering(N, 128, m, mask, sizes)
    k12(N, 128, m, (), torch.int32, mask, owners, bases, sizes, "doubling")
    # copy blocks of part of a slab: 2 KB items in 16-slot chunks, the last
    # chunk of a 100-slot slab ragged
    T, m = 100, 700
    mask = torch.rand((N, m), generator=gen, device=dev) < 0.8
    sizes = ints(0, 3 * T, (N,))
    owners, bases = covering(N, T, m, mask, sizes, short=1)
    k12(N, T, m, (8, 128), torch.bfloat16, mask, owners, bases, sizes, "doubling")
    # fuzzed tables: free slabs, owners past N, overlapping windows,
    # misaligned bases; payloads in 16-, 4-, 2- and 1-byte units
    for item, dtype in (((8,), torch.float32), ((3,), torch.float32), ((3,), torch.float16),
                        ((3,), torch.uint8), ((), torch.bfloat16), ((2, 128), torch.bfloat16)):
        for m in (37, 4097):
            T, N, P = 5, 7, 40
            S = 40
            owners = ints(-1, N + 1, (S,))
            bases = ints(0, P, (S,)) * T + ints(-1, 2, (S,)) * ints(0, 2, (S,))
            mask = torch.rand((N, m), generator=gen, device=dev) < 0.7
            k12(N, T, m, item, dtype, mask, owners, bases, ints(0, 3 * T, (N,)), "tz")
    emit({"phase": "kernel.append_edges", "card": card,
          "push_back_cases": seen["push_back_cases"], "slab_append_cases": seen["slab_append_cases"],
          "push_back_plans": sorted(seen["k3_plans"]), "slab_append_plans": sorted(seen["k12_plans"]),
          "push_back_units": sorted(seen["k3_units"]), "slab_append_units": sorted(seen["k12_units"])})
    check(seen["k3_units"] >= {16, 4, 2}, f"K3 edge cases missed a copy unit: {seen['k3_units']}")
    check(seen["k12_units"] >= {16, 4, 2, 1}, f"K12 edge cases missed a copy unit: {seen['k12_units']}")


def k12_inputs(gen, payload):
    """K12's and K9's timed inputs: the scalar arena's last grow wave (512
    arrays, slabs of 2048, m = 2048 * 2^7 onto sizes where seven waves left
    them) over a pool in doubling extents, and the page table of the arena
    after it (the freeze's gather) → (extents, owners, bases, sizes, elems,
    mask, pages)."""
    import torch

    m_last = B0 << (NWAVES - 1)
    sizes = torch.full((NBLOCKS,), int(0.9 * B0 * (2 ** (NWAVES - 1) - 1)), dtype=torch.int32, device=DEV)
    sizes += torch.randint(-(B0 // 2), B0 // 2, (NBLOCKS,), generator=gen, device=DEV, dtype=torch.int32)
    mask = torch.rand((NBLOCKS, m_last), generator=gen, device=DEV) < 0.9
    after = (sizes + mask.sum(1, dtype=torch.int32)).cpu().tolist()
    npages = [-(-a // B0) for a in after]
    sizes_e = _extent_sizes(sum(npages), "doubling")
    S = sum(sizes_e)
    owners, bases, pages = _arena_tables(npages, S, B0, gen)
    exts = _split(payload((S, B0), torch.float32), sizes_e)
    elems = payload((NBLOCKS, m_last), torch.float32)
    return exts, owners, bases, sizes, elems, mask, pages


def k8_inputs(gen, payload):
    """K8's timed inputs: the freeze's gather of the 1/8-size flat
    ("geometric") arena → (pool, pages)."""
    import torch

    t8 = B0 // 8
    npages = [-(-int(0.9 * t8 * (2 ** NWAVES - 1) + j) // t8) for j in range(0, 4 * NBLOCKS, 4)]
    S = 2 * sum(npages)  # geometric growth leaves up to half the pool free
    _, _, pages = _arena_tables(npages, S, t8, gen)
    return payload((S, t8), torch.float32), pages


def kv_inputs(gen, payload):
    """The KV-shaped arena's prefill wave: 64 arrays of (8, 128) bf16
    items, ragged lengths, into a zeroed pool of 2048-token slabs with room
    for the decode steps → (pool, owners, bases, sizes (zeros), elems,
    mask, pages)."""
    import torch

    lens = torch.randint(KV_MIN, KV_MAX + 1, (KV_ARRAYS,), generator=gen, device=DEV, dtype=torch.int32)
    mask = torch.arange(KV_MAX, device=DEV)[None, :] < lens[:, None]
    npages = [-(-(int(n) + KV_DECODE) // B0) for n in lens.cpu().tolist()]
    S = sum(npages)
    owners, bases, pages = _arena_tables(npages, S, B0, gen)
    pool = torch.zeros((S, B0, *KV_ITEM), dtype=torch.bfloat16, device=DEV)
    elems = payload((KV_ARRAYS, KV_MAX, *KV_ITEM), torch.bfloat16)
    zeros = torch.zeros((KV_ARRAYS,), dtype=torch.int32, device=DEV)
    return pool, owners, bases, zeros, elems, mask, pages


def kv_view(pool, pages):
    """The logical view's inputs after the decode steps: the pool in two
    extents and the page table widened to 16 pages → (extents, pages)."""
    import torch

    half = pool.shape[0] // 2
    wide = torch.full((KV_ARRAYS, 16), -1, dtype=torch.int32, device=DEV)
    wide[:, :pages.shape[1]] = pages
    return (pool[:half].clone(), pool[half:].clone()), wide


def gather_edge_cases(note) -> None:
    """K8/K9 at the edges of the gather's plan (``gather_plan``): N·P pages
    no multiple of a block's 512 pieces, a single page, slabs of 20, 10 and
    5 bytes (4-, 2- and 1-byte pieces), slabs that straddle blocks, 4 MB
    slabs, page -1 and ids past the pool, flat and through extents.  Each
    case launched without and with counters: every output bitwise the plain
    version, the counters ``ref.gather_counters``."""
    import torch

    from repro_torch.kernels.paged import kernel as k_pg
    from repro_torch.kernels.paged import ref as r_pg
    from repro_torch.obs import device as obs_device

    dev = torch.device(DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(117)
    for dtype, T, item, N, P in (
            (torch.float32, 64, (), 7, 19),  # 16-piece slabs, 32 a block: 133 pages
            (torch.float32, 1, (), 1, 1),  # a single page of one 4-byte piece
            (torch.float32, 5, (), 9, 13),  # 20-byte slabs: 4-byte pieces
            (torch.bfloat16, 5, (), 9, 13),  # 10 bytes: 2-byte pieces
            (torch.uint8, 5, (), 9, 13),  # 5 bytes: 1-byte pieces
            (torch.float32, 300, (8,), 5, 3),  # 9600 bytes: 600 pieces, pages straddle blocks
            (torch.bfloat16, 2048, (8, 128), 1, 2),  # a 4 MB slab: 512 blocks
            (torch.float32, 256, (), 300, 7)):  # 1 KB slabs, 2100 pages
        for layout in ("flat", "doubling"):
            sizes_e = _extent_sizes(N * P // 2 + 2, layout)
            S = sum(sizes_e)
            if dtype == torch.uint8:
                flat = torch.randint(0, 256, (S, T, *item), generator=gen, device=dev, dtype=dtype)
            else:
                flat = torch.randn((S, T, *item), generator=gen, device=dev).to(dtype)
            exts = _split(flat, sizes_e)
            pages = torch.randint(-1, S, (N, P), generator=gen, device=dev, dtype=torch.int32)
            pages.view(-1)[::7] = S + 3  # past the pool
            clip = len(exts) == 1
            got = k_pg.paged_gather_cuda(exts, pages, clip_high=clip)
            counted, blk = k_pg.paged_gather_cuda(exts, pages, clip_high=clip, instrument=True)
            f = tuple(e.reshape(e.shape[0], T, -1) for e in exts)
            want = (r_pg.gather_pages(f[0], pages) if clip else r_pg.gather_pages_extents(f, pages))
            want = want.reshape(got.shape)
            counters = r_pg.gather_counters(pages, S, clip)
            note("paged_gather" if clip else "paged_gather_extents",
                 [(got, want), (counted, want), (obs_device.from_block(blk), counters)])
            del flat, exts, got, counted
    torch.cuda.empty_cache()


# Attention tolerances of the reference's own tests
# (tests/kernels/test_attention_kernels.py): rtol = atol = 2e-3 in f32,
# test_flash_dtypes' 2e-2 in bf16.
ATTN_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
# K10/K11 against their plain version, every pool dtype, abs + rel: the f32
# walk and the tensor-core walk (q and P in hi + lo 16-bit halves) measured
# within 1e-5 on the H100, a tensor-core walk without the lo halves 4e-3
# (tools/paged_attend_variants.py, PERF.md), which ATTN_TOL["float32"]
# passes in most cases.
ATTEND_TOL = 1e-4
# K14 against its plain version: both accumulate in f32 and differ only in
# summation order (the plain f32 version alone is up to 13 f32 ulps of
# max|out| off a float64 one at these shapes) and in the last rounding to
# the output dtype, so the bound is tied to the output's scale: this many
# ulps of the output dtype at max|want|, no relative term.
K14_ULPS = {"float32": 256, "bfloat16": 2}


def k14_tol(want) -> float:
    """K14's absolute bound on ``want``'s elements: ``K14_ULPS`` ulps of its
    dtype at its largest magnitude (0 where ``want`` is all zeros)."""
    import math

    import torch

    m = float(want.abs().max().item()) if want.numel() else 0.0
    if m == 0.0:
        return 0.0
    ulp = torch.finfo(want.dtype).eps * 2.0 ** math.floor(math.log2(m))
    return K14_ULPS[str(want.dtype).split(".")[-1]] * ulp


def close(res: dict, name: str, got, want, tol: float, rtol: float | None = None) -> None:
    """Hold a float kernel's output against its plain version: elements
    with |got - want| > tol + rtol |want| count as mismatches (allclose;
    rtol defaults to tol)."""
    import torch

    rtol = tol if rtol is None else rtol
    g, w = got.double(), want.double()
    if g.shape != w.shape:
        bad, err = max(g.numel(), w.numel(), 1), float("inf")
    else:
        diff = (g - w).abs()
        bad = int((~(diff <= tol + rtol * w.abs())).sum().item())
        err = float(diff.max().item()) if diff.numel() else 0.0
    r = res[name]
    r["mismatches"] += bad
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["tolerance"] = max(r.get("tolerance", 0.0), tol)
    if rtol != tol:
        r["rtol"] = max(r.get("rtol", 0.0), rtol)
    r["cases"] += 1


def flash_case(res, gen, B, H, KH, Sq, Skv, D, dtype, causal, layout="bhsd"):
    """K13 on (B, H, S, D) views — contiguous, or strided out of the model's
    (B, S, H, D) layout — against ``ref.attention``.  f16 (which the
    reference's tests do not take) is held to the bf16 tolerance."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as k_fa
    from repro_torch.kernels.flash_attention import ref as r_fa

    def mk(heads, S):
        if layout == "bshd":
            return torch.randn((B, S, heads, D), generator=gen, device=DEV).to(dtype).transpose(1, 2)
        return torch.randn((B, heads, S, D), generator=gen, device=DEV).to(dtype)

    q, k, v = mk(H, Sq), mk(KH, Skv), mk(KH, Skv)
    out = torch.empty_like(q)
    got = k_fa.flash_attention_cuda(q, k, v, out, group=H // KH, causal=causal, sm_scale=D ** -0.5)
    want = r_fa.attention(q.reshape(B * H, Sq, D), k.reshape(B * KH, Skv, D), v.reshape(B * KH, Skv, D),
                          group=H // KH, causal=causal)
    tol = ATTN_TOL["float32" if dtype == torch.float32 else "bfloat16"]
    close(res, "flash_attention", got.reshape(B * H, Sq, D), want, tol)
    return q, k, v, out


def attend_inputs(gen, B, KH, G, D, T, S, P, dtype, lengths):
    """A random page table of distinct slabs for ``lengths`` (page -1 past
    each sequence's pages and in one random live-page hole), q and a pool."""
    import torch

    pages = torch.full((B, P), -1, dtype=torch.int32)
    perm = torch.randperm(S, generator=torch.Generator().manual_seed(S + P))
    k = 0
    for b, n in enumerate(lengths):
        for p in range(min(-(-int(n) // T), P)):
            pages[b, p] = int(perm[k])
            k += 1
    q = torch.randn((B, KH, G, D), generator=gen, device=DEV) * D ** -0.5
    pool_k = torch.randn((S, T, KH, D), generator=gen, device=DEV).to(dtype)
    pool_v = torch.randn((S, T, KH, D), generator=gen, device=DEV).to(dtype)
    lens = torch.as_tensor(lengths, dtype=torch.int32).to(DEV)
    return q, pool_k, pool_v, pages.to(DEV), lens


def serving_attend_inputs(gen):
    """K10/K11's timed inputs: q (8, 2, 8, 128) f32 over 2048-token bf16
    slabs, the lengths of BatchEngine's requests mid-decode → (q, k pool,
    v pool, pages, lengths tensor, lengths)."""
    import torch

    T, KH, G, D, Bq = SERVE_SLAB, 2, 8, 128, BATCH_SLOTS
    lengths = [int(x) for x in torch.randint(BATCH_MIN, BATCH_MAX + BATCH_NEW, (Bq,), generator=gen,
                                             device=DEV).cpu()]
    P = max(-(-n // T) for n in lengths)
    S = sum(-(-n // T) for n in lengths)
    return (*attend_inputs(gen, Bq, KH, G, D, T, S, P, torch.bfloat16, lengths), lengths)


def pool_extents(pool_k, pool_v, layout):
    """The K and V pools cut into the extents of ``layout`` (trimmed to the
    pool's slabs) → (k extents, v extents)."""
    S = pool_k.shape[0]
    sizes = _extent_sizes(S, layout)
    if sum(sizes) > S:
        sizes[-1] -= sum(sizes) - S
    sizes = [n for n in sizes if n > 0]
    return _split(pool_k, sizes), _split(pool_v, sizes)


def attend_case(res, q, pool_k, pool_v, pages, lens, layout):
    """K10 (flat) or K11 (extents) against ``ref.attend_paged`` on the
    reference's head-major view of the same pool."""
    from repro_torch.kernels.paged import kernel as k_pg
    from repro_torch.kernels.paged import ref as r_pg

    kx, vx = pool_extents(pool_k, pool_v, layout)
    got = k_pg.paged_attend_cuda(q, kx, vx, pages, lens)
    want = r_pg.attend_paged(q, pool_k.permute(2, 0, 1, 3), pool_v.permute(2, 0, 1, 3), pages, lens)
    close(res, "paged_attend" if len(kx) == 1 else "paged_attend_extents", got, want, ATTEND_TOL)
    return kx, vx


def push_back_multi_case(res, gen, n, b0, nlev, m, item, sizes, p_live=1.0):
    """The two-group K3 (k and v) against the plain push-back, group by
    group, bitwise."""
    from repro_torch.kernels.push_back import kernel as k_pb
    from repro_torch.kernels.push_back import ref as r_pb

    groups, elems, mask = multi_inputs(gen, n, b0, nlev, m, item, p_live)
    got = tuple(tuple(x.clone() for x in g) for g in groups)
    ns, pos = k_pb.push_back_cuda_multi(got, sizes, b0, elems, mask)
    pairs = []
    for g, (levels, e) in enumerate(zip(groups, elems)):
        want = tuple(x.clone() for x in levels)
        _, ws, wp = r_pb.push_back(want, sizes, b0, e, mask)
        pairs += [*zip(got[g], want), (ns, ws), (pos, wp)]
    r = res["push_back_multi"]
    for a, b in pairs:
        mism, err = compare(a, b)
        r["mismatches"] += mism
        r["max_abs_err"] = max(r["max_abs_err"], err)
    r["cases"] += 1
    return groups, elems, mask


def serve_kernel_cases(card: str, res: dict, timing: dict) -> None:
    """K13, K10/K11 and the two-group K3 against their plain versions at
    small ragged shapes and at the serving paths' shapes, then timed there."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as k_fa
    from repro_torch.kernels.flash_attention import ref as r_fa
    from repro_torch.kernels.paged import kernel as k_pg
    from repro_torch.kernels.paged import ref as r_pg
    from repro_torch.kernels.push_back import kernel as k_pb
    from repro_torch.kernels.push_back import ref as r_pb

    gen = torch.Generator(device=DEV)
    gen.manual_seed(13)
    # cases added after the first timings draw from ``more``: the timed
    # shapes below keep the inputs their earlier times were taken on
    more = torch.Generator(device=DEV)
    more.manual_seed(113)

    # K13: the reference test's shapes, a ragged length (100 = one tile of
    # its own), every head dim, both dtypes, causal and not, both layouts.
    for B, H, KH, Sq, Skv, D in ((1, 2, 2, 128, 128, 64), (1, 4, 2, 256, 256, 32),
                                 (1, 2, 2, 64, 128, 128), (2, 4, 2, 100, 100, 16),
                                 (3, 8, 1, 37, 37, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                flash_case(res, gen, B, H, KH, Sq, Skv, D, dtype, causal,
                           "bshd" if (B + D) % 2 else "bhsd")
    # the edges of the tensor-core kernel's tiles (64 query rows, 64 keys)
    # and of the reference's (128): lengths 63, 65, 127, 129 and 1000, causal
    # and not, bf16 and f32, both layouts; f16 at two of them; Sq < Skv
    # (not causal)
    for S, D in ((63, 16), (65, 32), (127, 64), (129, 128), (1000, 128)):
        for dtype in (torch.float32, torch.bfloat16) + ((torch.float16,) if S in (65, 1000) else ()):
            for causal in (True, False):
                for layout in ("bhsd", "bshd"):
                    flash_case(res, more, 1, 4, 2, S, S, D, dtype, causal, layout)
    for Sq, Skv, D in ((1, 200, 64), (65, 129, 128), (100, 1000, 32)):
        for dtype in (torch.float32, torch.bfloat16):
            flash_case(res, more, 2, 4, 1, Sq, Skv, D, dtype, False, "bshd")
    # the slice's shape: 4 prompts x 16 heads over 2 kv heads, 1792 tokens
    B, H, KH, S, D = SERVE_PROMPTS, 16, 2, SERVE_LEN, 128
    for causal in (False, True):
        q, k, v, out = flash_case(res, gen, B, H, KH, S, S, D, torch.bfloat16, causal, "bshd")

    def k13():
        return k_fa.flash_attention_cuda(q, k, v, out, group=H // KH, causal=True, sm_scale=D ** -0.5)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    # a bf16 view off the 16-byte grid is refused, not run
    flat = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16, device=DEV)
    odd = flat[1:].view(1, 2, 64, 64)
    try:
        k_fa.flash_attention_cuda(odd, odd, odd, torch.empty_like(odd), group=1, causal=True,
                                  sm_scale=1.0)
        refused = False
    except ValueError:
        refused = True
    check(refused, "flash_attention: a bf16 view off the 16-byte grid was launched")
    del flat, odd

    # deterministic: no atomics, no split over keys (serve.policies relies
    # on it for its bitwise first-step logits)
    first = out.clone()
    repeat = compare(k13(), first)[0]
    res["flash_attention"]["repeat_mismatches"] = repeat
    check(repeat == 0, f"flash_attention: two launches on the same inputs differ in {repeat} elements")
    qh, kh, vh = (x.reshape(-1, S, D) for x in (q, k, v))
    pairs = S * (S + 1) // 2  # causal (query, key) pairs per head
    # device times from CUDA-graph replays, the kernel's and SDPA's alike
    # (each one call from Python is in the shape string)
    timing["flash_attention"] = dict(
        ms=graph_ms(k13, 10),
        plain_ms=cuda_ms(lambda: r_fa.attention(qh, kh, vh, group=H // KH, causal=True), 3),
        library_ms=graph_ms(sdpa, 10),
        bound=bound_ms(2 * (2 * B * H * S * D + 2 * B * KH * S * D), 4 * B * H * pairs * D, card,
                       PEAK_BF16_FLOPS),
        shape=f"q ({B}, {S}, {H}, {D}) bf16 strided, kv heads {KH}, causal; CUDA-graph times; "
              f"one call from Python {cuda_ms(k13, 10)} ms, SDPA's {cuda_ms(sdpa, 10)} ms",
    )
    del q, k, v, out, qh, kh, vh, first

    # K10/K11: small ragged cases — page -1, lengths 0, inside a slab and at
    # a slab's end, flat / doubling / tz extents, f32 and bf16 pools.
    for dtype in (torch.float32, torch.bfloat16):
        for layout in ("flat", "doubling", "tz"):
            T, P, G, KH, D = 8, 5, 4, 2, 32
            lengths = [0, 3, 8, 17, 40, 29]
            S = sum(-(-n // T) for n in lengths) + 3
            q, pk, pv, pages, lens = attend_inputs(gen, len(lengths), KH, G, D, T, S, P, dtype, lengths)
            pages[4, 1] = -1  # an unclaimed hole inside a live sequence
            attend_case(res, q, pk, pv, pages, lens, layout)
    # the serving shape (serving_attend_inputs)
    q, pk, pv, pages, lens, lengths = serving_attend_inputs(gen)
    Bq, KH, G, D = q.shape
    P, T = pages.shape[1], pk.shape[1]
    live_bytes = 2 * sum(lengths) * KH * D * 2
    small = q.numel() * 4 * 2 + pages.numel() * 4 + Bq * 4
    idx = pages.clamp(min=0).flatten().long()
    kvmask = (torch.arange(P * T, device=DEV)[None, :] < lens[:, None])[:, None, None, :]

    def library():
        kg = pk.index_select(0, idx).view(Bq, P * T, KH, D).transpose(1, 2)
        vg = pv.index_select(0, idx).view(Bq, P * T, KH, D).transpose(1, 2)
        return F.scaled_dot_product_attention(q.reshape(Bq, KH * G, 1, D).to(torch.bfloat16), kg, vg,
                                              attn_mask=kvmask, scale=1.0, enable_gqa=True)

    for layout, name in (("flat", "paged_attend"), ("doubling", "paged_attend_extents")):
        kx, vx = attend_case(res, q, pk, pv, pages, lens, layout)
        # device times from CUDA-graph replays: each call is shorter than
        # its Python wrapper (cuda_ms of the kernel's wrapper, host-bound,
        # is in the shape string)
        timing[name] = dict(
            ms=graph_ms(lambda: k_pg.paged_attend_cuda(q, kx, vx, pages, lens), 20),
            plain_ms=graph_ms(lambda: r_pg.attend_paged(q, pk.permute(2, 0, 1, 3), pv.permute(2, 0, 1, 3),
                                                        pages, lens), 5),
            library_ms=graph_ms(library, 20),
            bound=bound_ms(live_bytes + small, 0, card),
            shape=f"q ({Bq}, {KH}, {G}, {D}) f32, {len(kx)} extent(s) of {T}-token bf16 slabs, "
                  f"pages ({Bq}, {P}), {sum(lengths)} live tokens, nsplit "
                  f"{k_pg.attend_splits(P, T, Bq * KH, torch.cuda.get_device_properties(0).multi_processor_count)}"
                  f"; CUDA-graph times; one call "
                  f"from Python {cuda_ms(lambda: k_pg.paged_attend_cuda(q, kx, vx, pages, lens), 20)} ms",
        )
        del kx, vx
    del q, pk, pv, pages, lens, idx, kvmask

    # the two-group K3: ragged waves over one and nine levels, then the
    # Engine's decode append (4 sequences, m = 1, items (2, 128) bf16, the
    # two levels of a cache grown once)
    for n, b0, nlev, m in ((3, 2, 1, 1), (5, 2, 9, 7), (37, 4, 4, 130)):
        cap = (b0 << nlev) - b0
        sizes = torch.randint(0, cap + 1, (n,), generator=gen, device=DEV, dtype=torch.int32)
        push_back_multi_case(res, gen, n, b0, nlev, m, (2, 8), sizes, p_live=0.6)
    sizes = torch.randint(SERVE_SLAB, 2 * SERVE_SLAB, (SERVE_PROMPTS,), generator=gen, device=DEV,
                          dtype=torch.int32)
    groups, elems, mask = push_back_multi_case(res, gen, SERVE_PROMPTS, SERVE_SLAB, 2, 1, (KH, D), sizes)
    item_bytes = KH * D * 2
    plan = k_pb.push_back_plan(1, 2 * item_bytes // 16)
    timing["push_back_multi"] = dict(
        ms=graph_ms(lambda: k_pb.push_back_cuda_multi(groups, sizes, SERVE_SLAB, elems, mask), 50),
        plain_ms=graph_ms(lambda: [r_pb.push_back(g, sizes, SERVE_SLAB, e, mask)
                                   for g, e in zip(groups, elems)], 20),
        library_ms=None,
        bound=bound_ms(SERVE_PROMPTS * (1 + 4 + 4 + 4 + 4 * item_bytes), 0, card),
        shape=f"2 groups x 2 levels of ({SERVE_PROMPTS}, {SERVE_SLAB}*2^b, {KH}, {D}) bf16, "
              f"wave ({SERVE_PROMPTS}, 1); CUDA-graph times; one call from Python "
              f"{cuda_ms(lambda: k_pb.push_back_cuda_multi(groups, sizes, SERVE_SLAB, elems, mask), 50)} ms; "
              f"launch floor (an empty kernel of the same {SERVE_PROMPTS} x {plan.threads} grid, same "
              f"harness) {graph_ms(lambda: k_pb.empty_launch_cuda(torch.device(DEV), SERVE_PROMPTS, plan.threads), 50)} ms",
    )
    del groups, elems, mask
    torch.cuda.empty_cache()
    attend_edge_cases(res)


def attend_edge_cases(res: dict) -> None:
    """K10/K11 at the edges of the split by the live length: lengths 0, 1,
    nsplit - 1, nsplit, nsplit + 1, one at a page's end, and one with a -1
    hole that straddles a split boundary and an id past the pool (clipped
    through one flat pool, skipped through extents); G in {1, 4, 8, 16}, D
    in {16, 32, 64, 128}, f32, bf16 and f16 pools.  Each launched without
    and with counters: the output within ATTEND_TOL of the plain
    version (fed the ids as the kernel resolves them), the counted output
    bitwise the uncounted one, the counters ``ref.attend_counters``.  Then
    B·KH past the ticket buffer's first size; a launch that would grow it
    inside a CUDA-graph capture refused; 20 replays of a captured launch and
    an eager launch after them bitwise equal to the eager launch before;
    the tickets left zero."""
    import torch

    from repro_torch.kernels.paged import kernel as k_pg
    from repro_torch.kernels.paged import ref as r_pg
    from repro_torch.obs import device as obs_device

    dev = torch.device(DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(118)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def one(q, pk, pv, pages, lens, layout):
        S, T, KH = pk.shape[:3]
        kx, vx = pool_extents(pk, pv, layout)
        clip = len(kx) == 1
        name = "paged_attend" if clip else "paged_attend_extents"
        got = k_pg.paged_attend_cuda(q, kx, vx, pages, lens)
        counted, blk = k_pg.paged_attend_cuda(q, kx, vx, pages, lens, instrument=True)
        resolved = pages.clamp(max=S - 1) if clip else torch.where(pages >= S, -1, pages)
        want = r_pg.attend_paged(q, pk.permute(2, 0, 1, 3), pv.permute(2, 0, 1, 3), resolved, lens)
        close(res, name, got, want, ATTEND_TOL)
        r = res[name]
        for a, b in ((counted, got),
                     (obs_device.from_block(blk), r_pg.attend_counters(pages, lens, T, KH, S, clip))):
            r["mismatches"] += compare(a, b)[0]
        r["edge_cases"] = r.get("edge_cases", 0) + 1
        return kx, vx

    T, P, KH = 64, 20, 2
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    for i, (D, G) in enumerate((d, g) for d in (16, 32, 64, 128) for g in (1, 4, 8, 16)):
        ns = k_pg.attend_splits(P, T, 7 * KH, sms)
        lengths = [0, 1, ns - 1, ns, ns + 1, 3 * T, 1000]
        S = sum(-(-n // T) for n in lengths) + 2
        q, pk, pv, pages, lens = attend_inputs(gen, len(lengths), KH, G, D, T, S, P, dtypes[i % 3], lengths)
        pages[6, 1] = -1  # keys 64..127: the split boundaries 1000 i / ns fall inside
        pages[6, 3] = S + 5  # past the pool
        for layout in ("flat", "doubling"):
            one(q, pk, pv, pages, lens, layout)
    res["paged_attend"]["edge_nsplit"] = ns

    # B * KH = 400, past the ticket buffer's first size (in counters, and so
    # in (sequence, head) pairs)
    B, G, D = 200, 8, 128
    lengths = [int(x) for x in torch.randint(0, P * T + 1, (B,), generator=gen, device=dev).cpu()]
    S = sum(-(-n // T) for n in lengths) + 1
    q, pk, pv, pages, lens = attend_inputs(gen, B, KH, G, D, T, S, P, torch.bfloat16, lengths)
    one(q, pk, pv, pages, lens, "doubling")
    tix = k_pg.attend_buffers(q.device, 0, 0)[0]
    check(tix.numel() > k_pg.ATTEND_TICKETS0, f"paged_attend: the ticket buffer did not grow ({tix.numel()})")
    check(int(tix.count_nonzero().item()) == 0, "paged_attend: a ticket was left non-zero")

    # a first launch past the buffer's size inside a capture is refused; once
    # an eager launch has grown it, replays match the eager launches
    B = tix.numel() // KH + 1
    lengths = [int(x) for x in torch.randint(0, P * T + 1, (B,), generator=gen, device=dev).cpu()]
    S = sum(-(-n // T) for n in lengths) + 1
    q, pk, pv, pages, lens = attend_inputs(gen, B, KH, G, D, T, S, P, torch.bfloat16, lengths)
    kx, vx = (pk,), (pv,)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            k_pg.paged_attend_cuda(q, kx, vx, pages, lens)
        refused = False
    except RuntimeError as e:
        refused = "before a CUDA-graph capture" in str(e)
    check(refused, "paged_attend: its buffers were grown inside a CUDA-graph capture")
    del graph
    fresh = k_pg.paged_attend_cuda(q, kx, vx, pages, lens)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k_pg.paged_attend_cuda(q, kx, vx, pages, lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = k_pg.paged_attend_cuda(q, kx, vx, pages, lens)
    for _ in range(20):
        graph.replay()
    torch.cuda.synchronize()
    after = k_pg.paged_attend_cuda(q, kx, vx, pages, lens)
    r = res["paged_attend"]
    for a, b in ((replayed, fresh), (after, fresh)):
        r["mismatches"] += compare(a, b)[0]
    check(int(k_pg.attend_buffers(q.device, 0, 0)[0].count_nonzero().item()) == 0,
          "paged_attend: a ticket was left non-zero after the replays")
    r["replay_cases"] = r.get("replay_cases", 0) + 1
    del graph, replayed, after, fresh, q, pk, pv, pages, lens, kx, vx
    torch.cuda.empty_cache()


# The reference's scan test shapes (tests/kernels/test_scan_kernels.py).
SCAN_SHAPES = ((1, 1), (1, 128), (3, 100), (8, 256), (5, 513), (16, 1024), (2, 4096))
# ... and its dispatch/combine and decode-attention test shapes
# (tests/kernels/test_dispatch_mxu.py, test_attention_kernels.py).
DISPATCH_SHAPES = ((8, 16, 8), (100, 64, 32), (128, 128, 128), (300, 512, 64))
DECODE_SHAPES = ((2, 8, 2, 256, 64), (1, 4, 4, 512, 32), (3, 16, 2, 128, 128))
# The f32 scan's tolerance: the reference test's rtol=1e-3, atol=1e-4.
SCAN_F32_RTOL, SCAN_F32_ATOL = 1e-3, 1e-4
# Float dispatch with repeated positions sums in the order the atomics land,
# each add rounded: |kernel - plain| <= tol * (sum of the slot's |addends|),
# tol 1e-5 (f32) / 2e-2 (bf16) for the at most 37 addends of these cases.
DISPATCH_REPEAT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def slice4_kernel_cases(card: str, res: dict, timing: dict) -> None:
    """K2 (tensor-core scan), K5a/K5b (dispatch, combine) and K14
    (flash-decode) against their plain versions at the reference tests'
    shapes, ragged ones and the main paths' shapes, then timed there."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import indexing
    from repro_torch.kernels.decode_attention import kernel as k_da
    from repro_torch.kernels.decode_attention import ref as r_da
    from repro_torch.kernels.dispatch_mxu import kernel as k_dm
    from repro_torch.kernels.dispatch_mxu import ref as r_dm
    from repro_torch.kernels.scan_mxu import kernel as k_sm
    from repro_torch.kernels.scan_mxu import ref as r_sm

    dev = torch.device(DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(14)
    # cases added after the first timings draw from ``more``: the timed
    # shapes below keep the inputs their earlier times were taken on
    more = torch.Generator(device=DEV)
    more.manual_seed(114)

    def note(name, pairs):
        r = res[name]
        for a, b in pairs:
            mism, err = compare(a, b)
            r["mismatches"] += mism
            r["max_abs_err"] = max(r["max_abs_err"], err)
        r["cases"] += 1

    # K2: 0/1 masks and full-range int32 (wrap-around) bitwise; f32 within
    # the reference's tolerance (normals at its shapes; positive values at
    # the grow path's, where a cumsum of normals crosses zero and atol rules)
    wide = ((NBLOCKS, B0 << 4), (NBLOCKS, B0 << (NWAVES - 1)))
    for shape in SCAN_SHAPES + ((17, 2049), (33, 1000)) + wide:
        mask = (torch.rand(shape, generator=gen, device=dev) < 0.5).to(torch.int32)
        full = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)
        note("row_scan_mxu", [(k_sm.row_scan_mxu_cuda(mask), r_sm.row_scan(mask)),
                              (k_sm.row_scan_mxu_cuda(full), r_sm.row_scan(full))])
        del full
        x = (torch.randn(shape, generator=gen, device=dev) if shape not in wide
             else torch.rand(shape, generator=gen, device=dev))
        close(res, "row_scan_mxu", k_sm.row_scan_mxu_cuda(x), r_sm.row_scan(x), SCAN_F32_ATOL,
              rtol=SCAN_F32_RTOL)
        del x
    x = (torch.rand(wide[-1], generator=gen, device=dev) < 0.9).to(torch.int32)
    timing["row_scan_mxu"] = dict(
        ms=cuda_ms(lambda: k_sm.row_scan_mxu_cuda(x), 20),
        plain_ms=cuda_ms(lambda: r_sm.row_scan(x), 20),
        library_ms=cuda_ms(lambda: torch.cumsum(x, 1, dtype=torch.int32), 20),
        bound=bound_ms(8 * x.numel(), x.numel(), card),
        shape=f"{wide[-1]} int32 0/1 mask (the last grow wave), one launch; "
              f"in CUDA-graph replays {graph_ms(lambda: k_sm.row_scan_mxu_cuda(x), 20)} ms",
    )
    del x, mask

    # K5a/K5b: the reference test's shapes, three payload types, unique
    # positions (bitwise); repeated positions (int32 bitwise, floats within
    # DISPATCH_REPEAT_TOL: sums in the order the atomics land)
    repeat = {"cases": 0, "max_abs_err": 0.0, "mismatches": 0}
    for T, S, D in DISPATCH_SHAPES + ((1000, 999, 1), (37, 5, 3)):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            x = (torch.randint(-2**30, 2**30, (T, D), generator=gen, device=dev, dtype=torch.int32)
                 if dtype == torch.int32 else torch.randn((T, D), generator=gen, device=dev).to(dtype))
            perm = torch.cat([torch.randperm(S, generator=gen, device=dev),
                              torch.full((max(T - S, 0),), -1, device=dev, dtype=torch.int64)])[:T]
            pos = torch.where(torch.rand(T, generator=gen, device=dev) < 0.8, perm, -1).to(torch.int32)
            buf = k_dm.dispatch_cuda(x, pos, S)
            note("dispatch", [(buf, r_dm.dispatch(x, pos, S))])
            note("combine", [(k_dm.combine_cuda(buf, pos), r_dm.combine(buf, pos, T))])
            far = torch.randint(-1, S + 3, (T,), generator=gen, device=dev, dtype=torch.int32)
            note("combine", [(k_dm.combine_cuda(buf, far), r_dm.combine(buf, far, T))])  # clipped ids
            rep = torch.randint(-1, max(S // 3, 1), (T,), generator=gen, device=dev, dtype=torch.int32)
            got, want = k_dm.dispatch_cuda(x, rep, S), r_dm.dispatch(x, rep, S)
            if dtype == torch.int32:
                note("dispatch", [(got, want)])
            else:
                tol = DISPATCH_REPEAT_TOL[str(dtype).split(".")[-1]]
                diff = (got.double() - want.double()).abs()
                mag = r_dm.dispatch(x.double().abs(), rep, S)
                repeat["mismatches"] += int((diff > tol * mag).sum().item())
                repeat["max_abs_err"] = max(repeat["max_abs_err"], float(diff.max().item()))
                repeat["cases"] += 1
    emit({"phase": "kernel.dispatch_repeats", "card": card, "tolerance": DISPATCH_REPEAT_TOL, **repeat})
    check(repeat["mismatches"] == 0, "dispatch: repeated positions outside the stated tolerance")

    # the freeze's shape: the main path's 8-level plane, (512 x 522240, 1)
    # f32 lanes, the live ones at their unique global positions
    cap = indexing.capacity(B0, NWAVES)
    sizes = torch.full((NBLOCKS,), int(0.9 * B0 * (2 ** NWAVES - 1)), dtype=torch.int32, device=dev)
    sizes += torch.randint(-(B0 // 2), B0 // 2, (NBLOCKS,), generator=gen, device=dev, dtype=torch.int32)
    starts = indexing.block_starts(sizes)
    posn = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    pos = torch.where(posn < sizes[:, None], starts[:, None] + posn, -1).reshape(-1)
    del posn
    n_lanes, n_live = pos.numel(), int(sizes.sum().item())
    x = torch.randn((n_lanes, 1), generator=gen, device=dev)
    buf = k_dm.dispatch_cuda(x, pos, n_lanes)
    note("dispatch", [(buf, r_dm.dispatch(x, pos, n_lanes))])
    dump = torch.where(pos < 0, n_lanes, pos).long()  # dropped lanes into a spare row

    def library_dispatch():
        return torch.zeros((n_lanes + 1, 1), device=dev).index_add_(0, dump, x)

    timing["dispatch"] = dict(
        ms=cuda_ms(lambda: k_dm.dispatch_cuda(x, pos, n_lanes), 5),
        plain_ms=cuda_ms(lambda: r_dm.dispatch(x, pos, n_lanes), 2),
        library_ms=cuda_ms(library_dispatch, 5),
        bound=bound_ms(4 * n_lanes * 3, 0, card),
        shape=f"x ({n_lanes}, 1) f32, {n_live} live unique positions -> ({n_lanes}, 1); "
              f"library: index_add_ into zeros with a spare row for the dropped lanes",
    )
    del dump
    note("combine", [(k_dm.combine_cuda(buf, pos), r_dm.combine(buf, pos, n_lanes))])
    gidx = pos.clamp(min=0).long()
    timing["combine"] = dict(
        ms=cuda_ms(lambda: k_dm.combine_cuda(buf, pos), 5),
        plain_ms=cuda_ms(lambda: r_dm.combine(buf, pos, n_lanes), 2),
        library_ms=cuda_ms(lambda: buf.index_select(0, gidx), 5),
        bound=bound_ms(4 * n_lanes * 2 + 4 * n_live, 0, card),
        shape=f"buf ({n_lanes}, 1) f32, pos ({n_lanes},), {n_live} live (the freeze read back); "
              f"library: index_select, no zeroing",
    )
    del x, buf, pos, gidx, sizes, starts
    torch.cuda.empty_cache()

    # K14: the reference test's shapes, both dtypes, head-major and the
    # static cache's token-major layout; lengths 0, inside a block and at S;
    # the dead tail
    def kv_pair(B, KH, S, D, dtype, layout, g=gen):
        if layout == "bshd":
            return tuple(torch.randn((B, S, KH, D), generator=g, device=dev).to(dtype).transpose(1, 2)
                         for _ in range(2))
        return tuple(torch.randn((B, KH, S, D), generator=g, device=dev).to(dtype) for _ in range(2))

    for B, H, KH, S, D in DECODE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for layout in ("bhsd", "bshd"):
                q = torch.randn((B, KH, H // KH, D), generator=gen, device=dev).to(dtype)
                k, v = kv_pair(B, KH, S, D, dtype, layout)
                for lens in (torch.randint(1, S + 1, (B,), generator=gen, device=dev),
                             torch.tensor([0, S // 2 + 3, S][:B], device=dev)):
                    lens = lens.to(torch.int32)
                    got = k_da.decode_attention_cuda(q, k, v, lens, sm_scale=D ** -0.5)
                    want = r_da.decode_attention(q, k, v, lens)
                    close(res, "decode_attention", got, want, k14_tol(want), rtol=0.0)
    B, H, KH, S, D = 1, 4, 2, 128, 32
    q = torch.randn((B, KH, H // KH, D), generator=gen, device=dev)
    k, v = kv_pair(B, KH, S, D, torch.float32, "bhsd")
    lens = torch.tensor([40], dtype=torch.int32, device=dev)
    clean = k_da.decode_attention_cuda(q, k, v, lens, sm_scale=D ** -0.5)
    k[:, :, 40:], v[:, :, 40:] = 1e6, -1e6
    note("decode_attention", [(k_da.decode_attention_cuda(q, k, v, lens, sm_scale=D ** -0.5), clean)])

    # the split by the live length: lengths 0, 1, nsplit - 1, nsplit and
    # nsplit + 1 keys (at most S), nsplit from S, B * KH and the SM count:
    # 27 (S 2048, an odd count), 21 with G = 1 (an odd number of states), 4
    # from a short S (100: one split per 32 positions) and 1 (S 24); lengths
    # below nsplit leave splits empty.  S is never below nsplit (at most one
    # split per 32 positions).  Then B * KH = 80, past the ticket buffer's
    # first size, so it grows.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, KH, G, S, D in ((5, 2, 8, 2048, 128), (13, 1, 1, 700, 64), (5, 1, 4, 100, 64),
                           (5, 2, 8, 24, 128), (40, 2, 8, 256, 128)):
        ns = k_da.num_splits(S, B * KH, sms)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, KH, G, D), generator=more, device=dev).to(dtype)
            k, v = kv_pair(B, KH, S, D, dtype, "bshd", more)
            lens = torch.tensor(([0, 1, ns - 1, ns, ns + 1] * B)[:B], dtype=torch.int32,
                                device=dev).clamp(min=0, max=S)
            got = k_da.decode_attention_cuda(q, k, v, lens, sm_scale=D ** -0.5)
            want = r_da.decode_attention(q, k, v, lens)
            close(res, "decode_attention", got, want, k14_tol(want), rtol=0.0)
        res["decode_attention"][f"nsplit_S{S}_BKH{B * KH}"] = ns
    tix = k_da.tickets(q.device, 0)
    check(tix.numel() >= 80, f"decode_attention: the ticket buffer did not grow ({tix.numel()})")
    check(int(tix.count_nonzero().item()) == 0, "decode_attention: a ticket was left non-zero")
    # a first launch at B * KH = 130 (3 splits), past the buffer's size, inside a
    # CUDA-graph capture is refused (the zero fill would only be recorded);
    # once an eager launch has grown the buffer, 20 replays of the captured
    # launch and then an eager launch are bitwise equal to the eager launch
    # before them (each launch leaves its tickets at 0)
    B, KH, G, S, D = 65, 2, 8, 512, 128
    check(k_da.tickets(dev, 0).numel() < B * KH, "decode_attention: the capture case needs no growth")
    q = torch.randn((B, KH, G, D), generator=more, device=dev).to(torch.bfloat16)
    k, v = kv_pair(B, KH, S, D, torch.bfloat16, "bshd", more)
    lens = torch.randint(0, S + 1, (B,), generator=more, device=dev).to(torch.int32)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            k_da.decode_attention_cuda(q, k, v, lens, sm_scale=D ** -0.5)
        refused = False
    except RuntimeError as e:
        refused = "before a CUDA-graph capture" in str(e)
    check(refused, "decode_attention: the ticket buffer was made inside a CUDA-graph capture")
    del graph
    fresh = k_da.decode_attention_cuda(q, k, v, lens, sm_scale=D ** -0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k_da.decode_attention_cuda(q, k, v, lens, sm_scale=D ** -0.5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = k_da.decode_attention_cuda(q, k, v, lens, sm_scale=D ** -0.5)
    for _ in range(20):
        graph.replay()
    torch.cuda.synchronize()
    after = k_da.decode_attention_cuda(q, k, v, lens, sm_scale=D ** -0.5)
    note("decode_attention", [(replayed, fresh), (after, fresh)])
    del graph, replayed, after, fresh

    res["decode_attention"]["tolerance_rule"] = (
        f"{K14_ULPS['bfloat16']} bf16 / {K14_ULPS['float32']} f32 ulps of max|want| per case, no rtol")

    # the serving shape: 4 sequences, 2 KV heads x 8 queries of 128, bf16,
    # token-major, the lengths of serve.policies' decode after its growth
    B, KH, G, D = SERVE_PROMPTS, 2, 8, 128
    S = 3 * SERVE_SLAB  # a frozen cache grown once: 2048 + 4096
    lengths = torch.randint(SERVE_MIN, SERVE_LEN + 1, (B,), generator=gen, device=dev) + POLICY_NEW - 1
    lengths[-1] = SERVE_LEN + POLICY_NEW - 1
    lens = lengths.to(torch.int32)
    q = torch.randn((B, KH, G, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = kv_pair(B, KH, S, D, torch.bfloat16, "bshd")
    want = r_da.decode_attention(q, k, v, lens)
    close(res, "decode_attention", k_da.decode_attention_cuda(q, k, v, lens, sm_scale=D ** -0.5),
          want, k14_tol(want), rtol=0.0)
    live = int(lens.sum().item())
    qs = q.reshape(B, KH * G, 1, D)
    kvmask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    timing["decode_attention"] = dict(
        ms=graph_ms(lambda: k_da.decode_attention_cuda(q, k, v, lens, sm_scale=D ** -0.5), 20),
        plain_ms=graph_ms(lambda: r_da.decode_attention(q, k, v, lens), 5),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(qs, k, v, attn_mask=kvmask,
                                                                   enable_gqa=True), 20),
        bound=bound_ms(2 * live * KH * D * 2 + 2 * q.numel() * 2 + 4 * B, 0, card),
        shape=f"q ({B}, {KH}, {G}, {D}) bf16 over a token-major ({B}, {S}, {KH}, {D}) bf16 cache, "
              f"{live} live tokens, nsplit {k_da.num_splits(S, B * KH, sms)}; CUDA-graph times; "
              f"one call from Python "
              f"{cuda_ms(lambda: k_da.decode_attention_cuda(q, k, v, lens, sm_scale=D ** -0.5), 20)} ms",
    )
    del q, k, v, qs, kvmask
    torch.cuda.empty_cache()


def freeze_edge_cases(res: dict) -> None:
    """K2's chained scan and K7's two source forms at the edges of their
    plans (a generator of their own).  K2: cols of 1, 31, 32, 33 and around
    and past the tile width W, rows not a multiple of 16 and 1; 0/1 masks
    and full-range int32 bitwise, f32 within the reference's tolerance; a
    launch that would grow the status buffer inside a CUDA-graph capture
    refused, then grown by an eager launch; 20 replays of a captured launch,
    then an eager launch, bitwise equal to the eager launch before them
    (int32 and f32); the status words and the ticket left zero.  K7, plane
    and levels, counted and uncounted, bitwise with ``ref.gather_global`` and
    ``ref.gather_counters``: ranges that straddle many owners, empty blocks
    at range edges, gaps between ``ends`` and the next start, live items
    past cap, ragged tails, cap = 1, 2-byte items, misaligned starts."""
    import torch

    from repro_torch.kernels.scan_mxu import kernel as k_sm
    from repro_torch.kernels.scan_mxu import ref as r_sm

    dev = torch.empty(0, device=DEV).device  # with its index: the buffers are kept by device
    gen = torch.Generator(device=DEV)
    gen.manual_seed(20)

    def note(name, pairs):
        r = res[name]
        for a, b in pairs:
            mism, err = compare(a, b)
            r["mismatches"] += mism
            r["max_abs_err"] = max(r["max_abs_err"], err)
        r["cases"] += 1
        r["edge_cases"] = r.get("edge_cases", 0) + 1

    # K2
    W = k_sm.TILE_COLS

    def k2(rows, cols):
        mask = (torch.rand((rows, cols), generator=gen, device=dev) < 0.5).to(torch.int32)
        full = torch.randint(-2**31, 2**31 - 1, (rows, cols), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)
        note("row_scan_mxu", [(k_sm.row_scan_mxu_cuda(mask), r_sm.row_scan(mask)),
                              (k_sm.row_scan_mxu_cuda(full), r_sm.row_scan(full))])
        # normals where a row's sum stays small; past that, atol rules where it crosses 0
        x = (torch.randn if cols <= 4096 else torch.rand)((rows, cols), generator=gen, device=dev)
        close(res, "row_scan_mxu", k_sm.row_scan_mxu_cuda(x), r_sm.row_scan(x), SCAN_F32_ATOL,
              rtol=SCAN_F32_RTOL)

    for rows, cols in ([(17, c) for c in (1, 31, 32, 33, W - 1, W, W + 1, 3 * W, 5 * W + 7)]
                       + [(1, c) for c in (1, 33, W + 1, 4 * W)] + [(16, W + 1), (5, 2 * W - 3)]):
        k2(rows, cols)
    status, _ = k_sm.scan_buffers(dev, 0)
    # one status word more than the buffer holds: refused under a capture
    rows, cols = 16 * (status.numel() // 16 + 1), 2 * W
    x = (torch.rand((rows, cols), generator=gen, device=dev) < 0.9).to(torch.int32)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            k_sm.row_scan_mxu_cuda(x)
        refused = False
    except RuntimeError as e:
        refused = "before a CUDA-graph capture" in str(e)
    check(refused, "row_scan_mxu: the status buffer was grown inside a CUDA-graph capture")
    del graph
    note("row_scan_mxu", [(k_sm.row_scan_mxu_cuda(x), r_sm.row_scan(x))])
    grown = k_sm.scan_buffers(dev, 0)[0].numel()
    check(grown > status.numel() > 0 and grown >= k_sm.scan_plan(rows, cols).status_words,
          f"row_scan_mxu: the status buffer did not grow ({status.numel()} -> {grown})")
    for x in (x, torch.randn((33, 3 * W + 1), generator=gen, device=dev)):
        fresh = k_sm.row_scan_mxu_cuda(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            k_sm.row_scan_mxu_cuda(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = k_sm.row_scan_mxu_cuda(x)
        for _ in range(20):
            graph.replay()
        torch.cuda.synchronize()
        note("row_scan_mxu", [(replayed, fresh), (k_sm.row_scan_mxu_cuda(x), fresh)])
        del graph, replayed
    torch.cuda.synchronize()
    status, ticket = k_sm.scan_buffers(dev, 0)
    check(int(status.count_nonzero().item()) == 0 and int(ticket.count_nonzero().item()) == 0,
          "row_scan_mxu: a status word or the ticket counter was left non-zero")
    res["row_scan_mxu"]["status_words"] = status.numel()
    k7_edge_cases(res, gen)


def k7_edge_cases(res: dict, gen) -> None:
    """K7's cases of :func:`freeze_edge_cases`."""
    import torch

    from repro_torch.core import indexing
    from repro_torch.kernels.flatten import kernel as k_fl
    from repro_torch.kernels.flatten import ref as r_fl
    from repro_torch.obs import device as obs_device

    dev = torch.device(DEV)

    def note(name, pairs):
        r = res[name]
        for a, b in pairs:
            r["mismatches"] += compare(a, b)[0]
        r["cases"] += 1
        r["edge_cases"] = r.get("edge_cases", 0) + 1

    def k7(n, b0, nlev, dtype, sizes, live=None):
        levels = tuple(torch.randn((n, w), generator=gen, device=dev).to(dtype)
                       if dtype != torch.int32 else
                       torch.randint(-2**31, 2**31 - 1, (n, w), generator=gen, device=dev,
                                     dtype=torch.int64).to(torch.int32)
                       for w in indexing.bucket_sizes(b0, nlev))
        sizes = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
        starts = indexing.block_starts(sizes)
        ends = starts + (sizes if live is None else torch.as_tensor(live, dtype=torch.int32, device=dev))
        plane = r_fl.compact_blocks(levels, b0)
        want = r_fl.gather_global(plane, starts, ends)
        want_ctr = r_fl.gather_counters(starts, ends, n, plane.shape[1])
        span = obs_device.pack(dev, **{"flatten.span_rows": (ends.long() - starts.long()).sum()})
        for launch in (lambda **kw: k_fl.segmented_gather_cuda(plane, starts, ends, **kw),
                       lambda **kw: k_fl.segmented_gather_levels_cuda(levels, b0, starts, ends, **kw)):
            out_c, blk = launch(instrument=True)
            note("segmented_gather", [(launch(), want), (out_c, want),
                                      (obs_device.from_block(blk) + span, want_ctr)])

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int32)

    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        # many owners a range (cap 30), some empty, with and without gaps
        sz = ints(0, 31, 300)
        sz[::7] = 0
        k7(300, 2, 4, dtype, sz)
        k7(300, 2, 4, dtype, sz, live=(sz.float() * torch.rand(300, generator=gen, device=dev)).int())
        # empty blocks where a range (4096 f32, 8192 bf16 items) or a tile starts, and first
        k7(12, 512, 4, dtype, [4096, 0, 0, 4096, 0, 4000, 96, 0, 0, 7680, 0, 1])
        k7(9, 512, 4, dtype, [0, 0, 4096, 0, 4096, 0, 7680, 0, 0])
        # live items past cap (21): clamped to the row's last item
        k7(3, 3, 3, dtype, [30, 5, 40])
        # cap = 1; a ragged tail (105 items); odd starts over many ranges, with gaps
        k7(1000, 1, 1, dtype, ints(0, 2, 1000))
        k7(5, 3, 3, dtype, ints(0, 22, 5))
        odd = ints(0, 15000, 64) * 2 + 1
        k7(64, 1024, 5, dtype, odd, live=odd - ints(0, 3, 64))
    check(res["segmented_gather"]["mismatches"] == 0, "segmented_gather: an edge case differs")


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
    check(launches["compact_blocks"] == 0, "the main path's segmented freeze launched K6")
    return launches


# --------------------------------------------------------------------------
# Phase 4b: the paper's comparison — the tensor-core insertion scan and the
# dispatch freeze on the main path, the static and semi-static baselines,
# and a single LFVector.
# --------------------------------------------------------------------------

def mxu_path(card: str, rng, gen) -> dict:
    """The main path with ``method="mxu"`` (K2), frozen by the segmented
    gather, then by the dispatch flatten (K6 + K5a); after the counts are
    read, ``combine`` (K5b) reads the frozen array back as a check."""
    import numpy as np
    import torch

    from repro_torch.core import indexing
    from repro_torch.kernels import common
    from repro_torch.kernels.dispatch_mxu import ops as dispatch_ops
    from repro_torch.kernels.flatten import ops as flatten_ops
    from repro_torch.runtime import TwoPhasePipeline

    common.reset_launch_counts()
    pipe = TwoPhasePipeline(nblocks=NBLOCKS, b0=B0, device=DEV)
    waves, t_grow = grow(pipe, rng, B0, "mxu", card)
    t0 = time.perf_counter()
    pipe.freeze()
    t_freeze = time.perf_counter() - t0
    full = check_frozen(pipe, waves, card, "mxu freeze")
    del waves, full["want"]
    seg = pipe.frozen
    disp = TwoPhasePipeline.from_ggarray(pipe.array, flatten_impl="dispatch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disp.freeze()
    torch.cuda.synchronize()
    t_dispatch = time.perf_counter() - t0
    # the dispatch adds each element into a zero slot (the reference's
    # scatter-add), so a -0.0 comes out +0.0: bitwise equal to seg + 0.0
    signed_zeros = int(((seg.data == 0) & torch.signbit(seg.data)).sum().item())
    check(compare(disp.frozen.data, seg.data + 0.0)[0] == 0,
          "mxu: the dispatch freeze differs from the segmented one (signs of zero aside)")
    check(torch.equal(disp.frozen.block_starts, seg.block_starts) and int(disp.frozen.size) == full["n"],
          "mxu: the dispatch freeze's size or block_starts differ")
    launches = common.launch_counts()
    # a check, not the path: read the frozen array back into the block-major
    # plane through combine (K5b), which no path of the reference calls
    arr = pipe.array
    cap = indexing.capacity(arr.b0, arr.nbuckets)
    starts = indexing.block_starts(arr.sizes)
    posn = torch.arange(cap, dtype=torch.int32, device=DEV)[None, :]
    pos = torch.where(posn < arr.sizes[:, None], starts[:, None] + posn, -1).reshape(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = dispatch_ops.combine(seg.data[:, None], pos)
    torch.cuda.synchronize()
    t_combine = time.perf_counter() - t0
    plane = flatten_ops.compact_blocks(arr.buckets, arr.b0)
    check(compare(back[:, 0], plane.reshape(-1))[0] == 0, "mxu: combine read-back differs from the levels")
    del back, plane, pos, posn, disp, seg, pipe, arr
    torch.cuda.synchronize()
    emit({"phase": "main.mxu", "card": card, "elements": full["n"], "alloc_elems": full["alloc"],
          "grow_s": t_grow, "freeze_s": t_freeze, "dispatch_freeze_s": t_dispatch,
          "negative_zeros_made_positive_by_dispatch": signed_zeros,
          "combine_read_s": t_combine, "launches": {k: v for k, v in launches.items() if v},
          "ok": True})
    for name in ("row_scan_mxu", "compact_blocks", "segmented_gather", "dispatch"):
        check(launches[name] >= 1, f"kernel {name} never launched on the main.mxu path")
    torch.cuda.empty_cache()
    return launches


def _timed(fn):
    """(result, wall ms) of ``fn`` between two synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def baselines_path(card: str, rng) -> dict:
    """The paper's comparison on the main path's eight waves: a static array
    pre-allocated to the final size, a semi-static array grown by realloc
    (copy_on_grow=True) and one with memMap accounting (copy_on_grow=False:
    only the allocation is timed), and GGArray, under the insertion methods
    scan, tile (K1) and mxu (K2).  One line per structure and method with
    per-wave insert and resize times, allocated over live elements and the
    bytes growth copied; every structure's contents are checked against the
    numpy expectation of its index order (flat arrays: wave after wave, lane
    order; GGArray: block-major)."""
    import numpy as np
    import torch

    from repro_torch.core import CapacityPlanner, SemiStaticArray, static_init, static_push_back
    from repro_torch.core import ggarray as gg
    from repro_torch.kernels import common
    from repro_torch.kernels.flatten import ops as flatten_ops

    waves = []
    for w in range(NWAVES):
        m = B0 << w
        waves.append((rng.standard_normal((NBLOCKS, m), dtype=np.float32),
                      rng.random((NBLOCKS, m), dtype=np.float32) < 0.9))
    want_flat = np.concatenate([v[mk] for v, mk in waves])
    want_gg = expected_order(waves)
    total = want_flat.size
    common.reset_launch_counts()
    lines = []

    def flat_run(kind: str, method: str) -> dict:
        arr = static_init(total, device=DEV) if kind == "static" else SemiStaticArray.create(
            NBLOCKS * B0, copy_on_grow=kind == "realloc", device=DEV)
        per_wave, copied, untimed = [], 0, 0
        for vals, mask in waves:
            elems = torch.from_numpy(vals.reshape(-1)).to(DEV)
            mk = torch.from_numpy(mask.reshape(-1)).to(DEV)
            resize_ms = 0.0
            if kind == "static":
                (arr, _), insert_ms = _timed(lambda: static_push_back(arr, elems, mk, method=method))
            else:
                while arr.size + elems.shape[0] > arr.capacity:
                    nbytes = arr.capacity * 4
                    if kind == "realloc":
                        _, ms = _timed(arr.grow)
                        copied += nbytes
                    else:  # memMap: time the allocation; the copy is made untimed
                        _, ms = _timed(arr.grow_alloc_only)
                        arr.grow()
                        untimed += nbytes
                    resize_ms += ms
                _, insert_ms = _timed(lambda: arr.push_back(elems, mk, method=method))
            cap = arr.capacity
            size = int((arr.size if kind == "static" else arr.arr.size).item())
            per_wave.append({"m": int(elems.shape[0]), "insert_ms": insert_ms, "resize_ms": resize_ms,
                             "alloc_over_live": cap / size, "copied_bytes": copied})
        data = arr.data if kind == "static" else arr.arr.data
        got = data[:total].cpu().numpy()
        check(np.array_equal(got.view(np.uint32), want_flat.view(np.uint32)),
              f"baselines {kind}/{method}: contents differ from the expected order")
        check(int(torch.count_nonzero(data[total:].view(torch.int32)).item()) == 0,
              f"baselines {kind}/{method}: slots past the size are not 0")
        return {"waves": per_wave, "capacity": cap, "copied_bytes": copied,
                "untimed_copy_bytes": untimed}

    def gg_run(method: str) -> dict:
        arr, planner = gg.init(NBLOCKS, B0, device=DEV), CapacityPlanner()
        per_wave = []
        for vals, mask in waves:
            elems = torch.from_numpy(vals).to(DEV)
            before = arr.nbuckets
            arr, resize_ms = _timed(lambda: planner.reserve(arr, vals.shape[1], mask=mask))
            (arr, _, headroom), insert_ms = _timed(lambda: gg.append(arr, elems, mask, method=method))
            planner.note_append(arr, headroom)
            per_wave.append({"m": int(elems.numel()), "insert_ms": insert_ms, "resize_ms": resize_ms,
                             "levels_added": arr.nbuckets - before,
                             "alloc_over_live": arr.capacity / int(arr.sizes.sum().item()),
                             "copied_bytes": 0})
        flat = flatten_ops.flatten(arr.buckets, arr.sizes, arr.b0)
        got = flat[:total].cpu().numpy()
        check(np.array_equal(got.view(np.uint32), want_gg.view(np.uint32)),
              f"baselines ggarray/{method}: contents differ from the expected order")
        check(arr.capacity < 2 * total + B0 * NBLOCKS, f"baselines ggarray/{method}: §V bound fails")
        return {"waves": per_wave, "capacity": arr.capacity, "copied_bytes": 0,
                "host_syncs": planner.host_syncs}

    for method in ("scan", "tile", "mxu"):
        for kind in ("static", "realloc", "memmap", "ggarray"):
            run = gg_run(method) if kind == "ggarray" else flat_run(kind, method)
            line = {"phase": "baselines", "card": card, "structure": kind, "method": method,
                    "elements": total, "insert_ms_total": sum(w["insert_ms"] for w in run["waves"]),
                    "resize_ms_total": sum(w["resize_ms"] for w in run["waves"]), **run, "ok": True}
            emit(line)
            lines.append(line)
            torch.cuda.empty_cache()
    launches = common.launch_counts()
    emit({"phase": "baselines.launches", "card": card, "launches": {k: v for k, v in launches.items() if v}})
    for name in ("row_scan", "row_scan_mxu"):
        check(launches[name] >= 1, f"kernel {name} never launched on the baselines path")
    return launches


def lfvector_path(card: str, gen) -> dict:
    """One LFVector (b0 = 2048) pushed to 2^22 float32 elements, the
    insertion method cycling through scan, tile (K1) and mxu (K2): indices,
    contents and the §V capacity bound checked."""
    import torch

    from repro_torch.core import LFVector
    from repro_torch.kernels import common

    common.reset_launch_counts()
    vec = LFVector.create(b0=LF_B0, device=DEV)
    chunks, push_ms, n = [], [], 0
    methods = ("scan", "tile", "mxu")
    for i, m in enumerate(LF_PUSHES):
        x = torch.randn(m, generator=gen, device=DEV)
        idx, ms = _timed(lambda: vec.push_back(x, method=methods[i % 3]))
        check(torch.equal(idx, torch.arange(n, n + m, dtype=torch.int32, device=DEV)),
              f"lfvector: push {i} returned wrong indices")
        chunks.append(x)
        push_ms.append(ms)
        n += m
    check(len(vec) == n == sum(LF_PUSHES), f"lfvector: size {len(vec)} != {sum(LF_PUSHES)}")
    check(compare(vec.to_array(), torch.cat(chunks))[0] == 0, "lfvector: to_array differs from the pushes")
    probe = torch.randint(0, n, (1 << 16,), generator=gen, device=DEV)
    check(compare(vec[probe], torch.cat(chunks)[probe])[0] == 0, "lfvector: reads differ")
    check(vec.capacity < 2 * n + LF_B0, f"lfvector: §V bound capacity {vec.capacity} >= 2n + b0")
    launches = common.launch_counts()
    emit({"phase": "lfvector", "card": card, "b0": LF_B0, "pushes": LF_PUSHES, "elements": n,
          "capacity": vec.capacity, "nbuckets": vec.nbuckets, "push_ms": push_ms,
          "launches": {k: v for k, v in launches.items() if v}, "ok": True})
    for name in ("row_scan", "row_scan_mxu"):
        check(launches[name] >= 1, f"kernel {name} never launched on the lfvector path")
    return launches


def slice4_core_paths(card: str, seed: int) -> dict:
    """main.mxu, baselines and lfvector, launch counts zeroed before each →
    the counts summed over the paths."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 400)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 401)
    runs = {"main.mxu": mxu_path(card, rng, gen), "baselines": baselines_path(card, rng),
            "lfvector": lfvector_path(card, gen)}
    total = {k: 0 for k in KERNELS}
    for counts in runs.values():
        for k, v in counts.items():
            total[k] += v
    return total


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
            "packer": ("slab_append", "paged_gather", "segmented_gather")}
    for path, names in need.items():
        for name in names:
            check(runs[path][name] >= 1, f"kernel {name} never launched on the {path} arena path")
    # the packer's pipeline backend freezes with K7 on the levels
    check(runs["packer"]["compact_blocks"] == 0, "the packer's segmented freeze launched K6")
    emit({"phase": "arena.launches", "card": card, "launches": runs,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    total = {k: 0 for k in KERNELS}
    for counts in runs.values():
        for k, v in counts.items():
            total[k] += v
    return total


# --------------------------------------------------------------------------
# Phase 6: serving qwen2.5-3b (Engine over the GGArray KV cache, BatchEngine
# over the slab arena).
# --------------------------------------------------------------------------

def clone_tree(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    return x


class Capture:
    """Record (cloned) the arguments of the first call of ``module.name``
    inside the ``with`` block — layer 0 of the first prefill or decode step
    — so the kernel can be held against its plain version on them later."""

    def __init__(self, module, name: str):
        self.module, self.name, self.orig, self.args = module, name, getattr(module, name), None

    def __enter__(self):
        def wrapper(*args, **kwargs):
            if self.args is None:
                self.args = clone_tree((args, kwargs))  # before the kernel writes in place
            return self.orig(*args, **kwargs)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def serve_model(seed: int):
    """qwen2.5-3b at full width with the reference's TPU-kernel settings
    (attention_impl="pallas", paged_attend_impl="pallas"), random bf16
    weights made on the card from the seed."""
    import dataclasses

    import torch

    from repro_torch.configs import get
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get(SERVE_ARCH), attention_impl="pallas", paged_attend_impl="pallas")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 300)
    return cfg, transformer.init_params(cfg, gen)


def kv_bytes_per_token(cfg) -> int:
    """K and V in bf16 in every attention layer (a Mamba layer holds none)."""
    return cfg.n_periods * cfg.layout.count("attn") * 2 * cfg.n_kv_heads * cfg.head_dim * 2


def check_captured_engine(res: dict, cap_fa, cap_pb) -> None:
    """Layer 0 of an Engine run's prefill (K13) and of its first decode
    step (K3, two groups) against the plain versions on the captured
    inputs."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as k_fa
    from repro_torch.kernels.flash_attention import ref as r_fa
    from repro_torch.kernels.push_back import kernel as k_pb
    from repro_torch.kernels.push_back import ref as r_pb

    (q, k, v, o_), kw = cap_fa.args
    got = k_fa.flash_attention_cuda(q, k, v, torch.empty_like(o_), **kw)
    B, H, S, D = q.shape
    want = r_fa.attention(q.reshape(B * H, S, D), k.reshape(-1, S, D), v.reshape(-1, S, D),
                          group=kw["group"], causal=kw["causal"])
    tol = ATTN_TOL["float32" if q.dtype == torch.float32 else "bfloat16"]
    close(res, "flash_attention", got.reshape(B * H, S, D), want, tol)
    (groups, sizes, b0, elems, mask), _ = cap_pb.args
    work = clone_tree(groups)
    ns, pos = k_pb.push_back_cuda_multi(work, sizes, b0, elems, mask)
    r = res["push_back_multi"]
    for g, e, w in zip(groups, elems, work):
        _, ws, wp = r_pb.push_back(g, sizes, b0, e, mask)
        for a, b in [*zip(w, g), (ns, ws), (pos, wp)]:
            r["mismatches"] += compare(a, b)[0]
    r["cases"] += 1


def timed_prefill(params, cfg, prompts) -> tuple:
    """Engine's prefill of ``prompts`` (right-padded, K13 in every layer)
    and its first token, timed on the host clock around synchronised work
    → (logits, caches, prefill seconds, TTFT seconds)."""
    import numpy as np
    import torch

    from repro_torch.serving import steps
    from repro_torch.serving.sampler import sample

    L = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), L), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    toks_d = torch.from_numpy(toks).to(DEV)
    lens_d = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = steps.prefill(params, toks_d, cfg, capacity_hint=L, policy="ggarray",
                                   lengths=lens_d)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    sample(None, logits)
    torch.cuda.synchronize()
    return logits, caches, prefill_s, time.perf_counter() - t0


def serve_engine_path(card: str, cfg, params, rng, res: dict) -> dict:
    """Engine(policy="ggarray"): 4 prompts, 320 new tokens, one growth."""
    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import kernel as k_fa
    from repro_torch.kernels.push_back import kernel as k_pb
    from repro_torch.serving import steps
    from repro_torch.serving.engine import Engine

    lens = rng.integers(SERVE_MIN, SERVE_LEN + 1, SERVE_PROMPTS)
    lens[-1] = SERVE_LEN
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    common.reset_launch_counts()
    eng = Engine(params, cfg, device=DEV)
    with Capture(k_fa, "flash_attention_cuda") as cap_fa, Capture(k_pb, "push_back_cuda_multi") as cap_pb, \
            StepTimer(steps, "decode_step") as timer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompts, SERVE_NEW)  # ends in the token drain: synchronised
        wall = time.perf_counter() - t0
    launches = common.launch_counts()
    syncs = eng.obs.registry.counter("serve.host_syncs")
    st = eng.stats
    check(st.grow_events >= 1, "serve.engine: the cache never grew")
    check(st.copied_bytes == 0, "serve.engine: ggarray growth copied bytes")
    check(st.host_syncs == 1 and syncs.value(site="token_drain") == 1,
          f"serve.engine: {st.host_syncs} host syncs, expected only the final token drain")
    for p, o in zip(prompts, out):
        check(len(o) == len(p) + SERVE_NEW and o[:len(p)] == p, "serve.engine: output length / prompt")
        check(all(0 <= t < cfg.vocab_size for t in o[len(p):]), "serve.engine: token outside the vocab")
    for name in ("flash_attention", "push_back_multi"):
        check(launches[name] >= 1, f"kernel {name} never launched on the serve.engine path")

    check_captured_engine(res, cap_fa, cap_pb)
    del cap_fa, cap_pb

    # the K/V the growth must carry (written before the first step after
    # it) and the prompts' K/V, for serve.policies
    check(timer.grown_step is not None, "serve.engine: no decode step ran after the growth")
    lens_d = torch.from_numpy(lens.astype(np.int32)).to(DEV)
    kv_prompt = kv_written_before(eng.caches, lens_d)
    kv_before_growth = kv_written_before(eng.caches, lens_d + timer.grown_step)
    for what, lg in (("first", timer.first_logits), ("first after the growth", timer.grown_logits)):
        check(bool(torch.isfinite(lg).all().item()), f"serve.engine: the {what} decode step's logits not finite")

    # timed: prefill (K13 in every layer) and the first token; the decode
    # steps are the generate run's, timed by CUDA events under the sync check
    logits, caches, prefill_s, ttft_s = timed_prefill(params, cfg, prompts)
    check(bool(torch.isfinite(logits).all().item()), "serve.engine: prefill logits not finite")
    step_ms = timer.step_ms()
    live_tokens = int(lens.sum()) + SERVE_PROMPTS * (SERVE_NEW - 1)
    line = {"phase": "serve.engine", "card": card, "arch": SERVE_ARCH, "prompts": lens.tolist(),
            "new_tokens": SERVE_NEW, "prefill_s": prefill_s, "ttft_s": ttft_s,
            "prefill_tokens_per_s": SERVE_PROMPTS * SERVE_LEN / prefill_s,
            "decode_step_ms_median": step_ms[len(step_ms) // 2], "decode_steps": len(step_ms),
            "decode_step_ms_max": step_ms[-1], "first_step_after_growth": timer.grown_step,
            "generate_s": wall, "tokens_per_s": SERVE_PROMPTS * SERVE_NEW / wall,
            "grow_events": st.grow_events, "copied_bytes": st.copied_bytes,
            "allocated_kv_bytes": st.allocated_bytes,
            "live_kv_bytes": live_tokens * kv_bytes_per_token(cfg), "host_syncs": st.host_syncs,
            "launches": {k: v for k, v in launches.items() if v}, "ok": True}
    emit(line)
    first = logits.float()
    del caches, logits, eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"prompts": prompts, "out": out, "logits": first, "launches": launches,
            "step_logits": timer.first_logits, "grown_logits": timer.grown_logits,
            "grow_step": timer.grown_step, "kv_prompt": kv_prompt,
            "kv_before_growth": kv_before_growth}


def drive_batch(be) -> tuple:
    """Step ``be`` until it is idle, every steady step (no prompt pending or
    prefilling) under ``torch.cuda.set_sync_debug_mode("error")`` between
    two CUDA events, then drain it → (outputs, step events, wall seconds)."""
    import torch

    steady_ev = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        quiet = not be.sched.pending and not be.sched.prefilling
        if quiet:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.set_sync_debug_mode("error")
            try:
                a.record()
                more = be.step()
                b.record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            steady_ev.append((a, b))
        else:
            more = be.step()
        if not more:
            break
    out = be.run()  # the two drains
    return out, steady_ev, time.perf_counter() - t0


def serve_batch_path(card: str, cfg, params, rng, grow_chunk, nreq: int, res: dict,
                     what: str | None = None) -> tuple:
    """BatchEngine: 8 slots, ``nreq`` requests of 512-4096 prompt tokens and
    64 new tokens, chunked admission; steady decode steps under the sync
    check → (launch counts, the prompts, the phase's line)."""
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.paged import kernel as k_pg
    from repro_torch.kernels.paged import ref as r_pg
    from repro_torch.serving.engine import BatchEngine

    what = f"serve.batch.{grow_chunk}" if what is None else what
    lens = rng.integers(BATCH_MIN, BATCH_MAX + 1, nreq)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    common.reset_launch_counts()
    be = BatchEngine(params, cfg, max_batch=BATCH_SLOTS, grow_chunk=grow_chunk, device=DEV)
    rids = [be.submit(p, BATCH_NEW) for p in prompts]
    with Capture(k_pg, "paged_attend_cuda") as cap:
        out, steady_ev, wall = drive_batch(be)
    launches = common.launch_counts()
    st = be.stats
    syncs = be.obs.registry.counter("serve.host_syncs")
    run_syncs = st.host_syncs  # before check_free_list, which reads the device
    check(run_syncs == 2 and syncs.value(site="stream_drain") == 1
          and syncs.value(site="first_token_drain") == 1,
          f"{what}: {run_syncs} host syncs, expected the two drains of run()")
    be.check_free_list()
    # The reference holds its flat pool (grow_chunk=1) to pool < 2 peak live
    # + T max_batch (tests/serving/test_batch_engine.py:81).  Doubling
    # extents may overshoot the demand (live + one partial slab per slot,
    # reserved prompts included) by up to 2x, so that run is held to
    # 2 (peak live + T max_batch).
    bound = (2 * st.peak_live_tokens + be.T * be.B if grow_chunk == 1
             else 2 * (st.peak_live_tokens + be.T * be.B))
    check(st.peak_pool_tokens < bound, f"{what}: pool {st.peak_pool_tokens} >= bound {bound}")
    check(st.reused_slabs > 0, f"{what}: completed sequences' slabs were not reused")
    check(len(steady_ev) >= 1, f"{what}: no steady-state decode step")
    extents = sum(1 for n in be._extent_sizes if n > 0) if grow_chunk == "doubling" else 1
    if grow_chunk == "doubling":
        check(st.pool_copied_bytes == 0, f"{what}: extent growth copied pool bytes")
        check(extents > 1, f"{what}: the pool never grew past one extent")
    for rid, p in zip(rids, prompts):
        o = out[rid]
        check(len(o) == len(p) + BATCH_NEW and o[:len(p)] == p, f"{what}: output length / prompt")
        check(all(0 <= t < cfg.vocab_size for t in o[len(p):]), f"{what}: token outside the vocab")
    need = "paged_attend_extents" if grow_chunk == "doubling" else "paged_attend"
    check(launches[need] >= 1, f"kernel {need} never launched on the {what} path")

    # layer 0 of the first decode step, against the plain version
    (q, kx, vx, pages, lens_d), _ = cap.args
    got = k_pg.paged_attend_cuda(q, kx, vx, pages, lens_d)
    want = r_pg.attend_paged(q, torch.cat(kx).permute(2, 0, 1, 3), torch.cat(vx).permute(2, 0, 1, 3),
                             pages, lens_d)
    close(res, "paged_attend" if len(kx) == 1 else "paged_attend_extents", got, want, ATTEND_TOL)
    del cap, q, kx, vx, got, want
    torch.cuda.synchronize()
    step_ms = sorted(a.elapsed_time(b) for a, b in steady_ev)
    ttft = be.obs.registry.histogram("serve.ttft_ms")
    generated = sum(len(out[r]) - len(p) for r, p in zip(rids, prompts))
    line = {"phase": what, "card": card, "arch": cfg.name, "requests": nreq, "slots": BATCH_SLOTS,
          "prompt_tokens": int(lens.sum()), "new_tokens": BATCH_NEW, "run_s": wall,
          "tokens_per_s": generated / wall, "prefill_tokens_per_s_overall": int(lens.sum()) / wall,
          "ttft_ms_median": ttft.quantile(0.5), "ttft_ms_max": ttft.quantile(1.0),
          "steady_steps": len(steady_ev), "steady_step_ms_median": step_ms[len(step_ms) // 2],
          "decode_steps": st.decode_steps, "prefill_chunks": st.prefill_chunks,
          "peak_live_tokens": st.peak_live_tokens, "peak_pool_tokens": st.peak_pool_tokens,
          "pool_bound_tokens": bound,
          "pool_grow_events": st.pool_grow_events, "pool_copied_bytes": st.pool_copied_bytes,
          "reused_slabs": st.reused_slabs, "extents": extents, "host_syncs": run_syncs,
            "launches": {k: v for k, v in launches.items() if v}, "ok": True}
    emit(line)
    del be
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches, prompts, line


def serve_cross_check(card: str, cfg, params, engine_run: dict) -> None:
    """Engine's last-position prefill logits (K13, one padded batch) against
    BatchEngine's (chunked prefill, one prompt at a time) on the same
    prompts; the share of greedy tokens on which the two agree is printed,
    not gated (random weights make near-ties)."""
    import torch

    from repro_torch.serving.engine import BatchEngine

    class Capturing(BatchEngine):
        def _finish_prefill(self, req, slot, logits):
            self.prefill_logits[req.rid] = logits[0].float()
            super()._finish_prefill(req, slot, logits)

    be = Capturing(params, cfg, max_batch=BATCH_SLOTS, grow_chunk="doubling", device=DEV)
    be.prefill_logits = {}
    prompts = engine_run["prompts"]
    n_new = BATCH_NEW
    out = be.run_all(prompts, n_new)
    V = cfg.vocab_size  # the padded vocab columns hold -1e30 on both sides
    a = engine_run["logits"][:, :V]
    b = torch.stack([be.prefill_logits[r] for r in range(len(prompts))])[:, :V]
    rel = float(((a - b).norm() / a.norm()).item())
    err = float((a - b).abs().max().item())
    same = sum(x == y for o, e, p in zip(out, engine_run["out"], prompts)
               for x, y in zip(o[len(p):], e[len(p):len(p) + n_new]))
    # bf16 activations through 36 layers, two attention paths (K13 on the
    # padded batch, chunked f32 einsums one prompt at a time)
    tol = 5e-2
    emit({"phase": "serve.cross_check", "card": card, "prompts": len(prompts),
          "logits_max_abs_err": err, "logits_max_abs": float(a.abs().max().item()),
          "logits_rel_l2_err": rel, "rel_l2_tolerance": tol,
          "greedy_agreement": same / (len(prompts) * n_new), "ok": rel <= tol})
    check(rel <= tol, f"serve cross-check: prefill logits differ by {rel} (relative L2) > {tol}")
    del be
    torch.cuda.empty_cache()


class StepTimer:
    """Wrap ``module.name`` (a decode step, ``(params, token, caches, ...)``)
    inside the ``with`` block: each call runs under
    ``torch.cuda.set_sync_debug_mode("error")`` between two recorded CUDA
    events.  The logits of the first call are kept, and those of the first
    call whose cache capacity (read from shapes) differs from the first
    call's — the first step after a growth — with that call's index, and
    the last call's.  A stack without attention slots has no capacity."""

    def __init__(self, module, name: str):
        self.module, self.name, self.orig = module, name, getattr(module, name)
        self.events, self.first_logits, self.last_logits = [], None, None
        self.grown_logits, self.grown_step, self.capacity = None, None, None

    def __enter__(self):
        import torch

        from repro_torch.serving import kvcache

        def wrapper(*args, **kwargs):
            cap = next((kvcache.capacity_of(c) for c in args[2] if "ssd" not in c), None)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.set_sync_debug_mode("error")
            try:
                a.record()
                out = self.orig(*args, **kwargs)
                b.record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            self.events.append((a, b))
            self.last_logits = out[0]
            if self.first_logits is None:
                self.first_logits, self.capacity = out[0].float().clone(), cap
            elif self.grown_logits is None and cap != self.capacity:
                self.grown_logits, self.grown_step = out[0].float().clone(), len(self.events) - 1
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def step_ms(self) -> list:
        return sorted(a.elapsed_time(b) for a, b in self.events)


# Engine's logits where the same bf16 model and the same cache contents meet
# attention summed over another layout: static's 2064 keys against 2048 at
# the first step, and after the growth ggarray's two levels (2048 + 4096)
# against semistatic's one 4096 and two_phase's one 6144.  The f32 sums
# differ in order, which flips bf16 roundings that 36 layers carry: static
# read a relative L2 of 0.0086 on an H100 (PERF.md); the bound is 3x that.
# Where the layouts match (the first step of semistatic and two_phase
# against ggarray), the logits are held bitwise.
ORDER_LOGITS_TOL = 3e-2


def cache_kv(c: dict, name: str):
    """A cache slot's K or V (``name``) as one tensor, (..., B, capacity,
    KH, D): the contiguous cache's own, or a ggarray's levels in order."""
    import torch

    if name in c:
        return c[name]
    levels = []
    while f"{name}{len(levels)}" in c:
        levels.append(c[f"{name}{len(levels)}"])
    return torch.cat(levels, dim=-3)


def kv_written_before(caches, upto) -> list:
    """Every cache slot's K and V at the positions below ``upto`` (B,) of
    each sequence, gathered: the part written before a given step."""
    import torch

    out = []
    for c in caches:
        for name in ("k", "v"):
            x = cache_kv(c, name)
            x = x.reshape(-1, *x.shape[-4:])
            live = torch.arange(x.shape[-3], device=x.device)[None, :] < upto[:, None]
            out.append(x[:, live])
    return out


def rel_l2(a, b, V: int) -> float:
    a, b = a[:, :V], b[:, :V]
    return float(((a - b).norm() / a.norm()).item())


def serve_policies_path(card: str, cfg, params, engine_run: dict, res: dict) -> dict:
    """Engine under static (max_len = longest prompt + new tokens),
    semistatic and two_phase on serve.engine's prompts: TTFT, decode steps
    (CUDA events, under the sync check), grow/freeze events, copied and
    allocated bytes, host syncs.  The K/V written before the growth (the
    prompts' for static) must equal ggarray's bitwise, the first step's
    logits too (static within ``ORDER_LOGITS_TOL``), and the first step
    after the growth within ``ORDER_LOGITS_TOL``.  After the counts are
    read, K14 runs through its op on layer 0 of the first decode step's
    captured contiguous cache and is held against its plain version and
    ``kvcache.attend``'s output for the same step."""
    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.decode_attention import kernel as k_da
    from repro_torch.kernels.decode_attention import ops as o_da
    from repro_torch.kernels.decode_attention import ref as r_da
    from repro_torch.serving import kvcache, steps
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import sample

    prompts = engine_run["prompts"]
    lens = np.asarray([len(p) for p in prompts], np.int32)
    Lp = int(lens.max())
    toks = np.zeros((len(prompts), Lp), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    toks_d, lens_d = torch.from_numpy(toks).to(DEV), torch.from_numpy(lens).to(DEV)
    per_token = kv_bytes_per_token(cfg)
    cap0 = kvcache.cache_capacity(cfg, "semistatic", Lp)  # the first capacity of the growing policies
    V = cfg.vocab_size
    first = {"ggarray": engine_run["step_logits"]}
    grown = {"ggarray": engine_run["grown_logits"]}
    kv_mismatches, runs, summary = {}, {}, {}
    for policy in ("static", "semistatic", "two_phase"):
        common.reset_launch_counts()
        eng = Engine(params, cfg, policy=policy, max_len=Lp + POLICY_NEW, device=DEV)
        with StepTimer(steps, "decode_step") as timer, Capture(kvcache, "attend") as cap:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.generate(prompts, POLICY_NEW)  # ends in the token drain: synchronised
            wall = time.perf_counter() - t0
        launches = common.launch_counts()
        st = eng.stats
        check(st.host_syncs == 1, f"serve.{policy}: {st.host_syncs} host syncs, expected the token drain")
        for p, o in zip(prompts, out):
            check(len(o) == len(p) + POLICY_NEW and o[:len(p)] == p, f"serve.{policy}: output length / prompt")
            check(all(0 <= t < V for t in o[len(p):]), f"serve.{policy}: token outside the vocab")
        check(launches["flash_attention"] >= 1, f"kernel flash_attention never launched on the serve.{policy} path")
        # the K/V that the growth carried (the prompts' for static), bitwise ggarray's
        if policy == "static":
            check(st.grow_events == 0 and st.copied_bytes == 0, "serve.static: the static cache grew or copied")
            check(timer.grown_logits is None, "serve.static: the cache capacity changed")
            want, upto = engine_run["kv_prompt"], lens_d
        else:
            check(st.grow_events == 1, f"serve.{policy}: {st.grow_events} growths, expected 1")
            check(st.copied_bytes == len(prompts) * cap0 * per_token,
                  f"serve.{policy}: copied {st.copied_bytes} bytes, expected one copy of the first cache")
            check(timer.grown_step == engine_run["grow_step"],
                  f"serve.{policy}: grew before step {timer.grown_step}, ggarray before {engine_run['grow_step']}")
            want, upto = engine_run["kv_before_growth"], lens_d + timer.grown_step
            grown[policy] = timer.grown_logits
        kv_mismatches[policy] = sum(compare(x, y)[0] for x, y in zip(kv_written_before(eng.caches, upto), want))
        check(kv_mismatches[policy] == 0,
              f"serve.{policy}: {kv_mismatches[policy]} K/V elements written before the growth differ from ggarray's")
        if policy == "two_phase":
            check(st.freeze_events == 2, f"serve.two_phase: {st.freeze_events} freezes, expected 2")
        # not the path: K14 (no caller in the reference's paths) on layer 0
        # of the first decode step's captured contiguous cache, against its
        # plain version and kvcache.attend's output for the same step
        (c, q, length, _), _ = cap.args
        B, _, H, D = q.shape
        kview, vview = c["k"].transpose(1, 2), c["v"].transpose(1, 2)  # (B, KH, cap, D), no copy
        op_out = o_da.decode_attention(q[:, 0], kview, vview, length)
        KH = kview.shape[1]
        qg = q[:, 0].reshape(B, KH, H // KH, D).contiguous()
        got = k_da.decode_attention_cuda(qg, kview, vview, length.to(torch.int32), sm_scale=D ** -0.5)
        want = r_da.decode_attention(qg, kview, vview, length)
        close(res, "decode_attention", got, want, k14_tol(want), rtol=0.0)
        attend_out = kvcache.attend(c, q, length, cfg).reshape(B, H, D)
        attend_err = float((op_out.float() - attend_out.float()).abs().max().item())
        check(attend_err <= k14_tol(attend_out),
              f"serve.{policy}: K14 on the cache differs from kvcache.attend by {attend_err}")
        del cap, c, q, kview, vview, op_out, got, want, attend_out
        # TTFT: the policy's prefill (a frozen copy for two_phase) and the first sample
        hint = Lp + POLICY_NEW if policy == "static" else Lp
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = steps.prefill(params, toks_d, cfg, capacity_hint=hint,
                                       policy="ggarray" if policy == "two_phase" else policy,
                                       lengths=lens_d)
        if policy == "two_phase":
            caches = [kvcache.freeze_cache(cc) for cc in caches]
        sample(None, logits)
        torch.cuda.synchronize()
        ttft_s = time.perf_counter() - t0
        del logits, caches
        torch.cuda.synchronize()
        step_ms = timer.step_ms()
        first[policy] = timer.first_logits
        live_tokens = int(lens.sum()) + len(prompts) * (POLICY_NEW - 1)
        agree = sum(x == y for o, e, p in zip(out, engine_run["out"], prompts)
                    for x, y in zip(o[len(p):], e[len(p):len(p) + POLICY_NEW]))
        line = {"phase": f"serve.policies.{policy}", "card": card, "arch": SERVE_ARCH,
                "prompts": lens.tolist(), "new_tokens": POLICY_NEW, "ttft_s": ttft_s,
                "decode_step_ms_median": step_ms[len(step_ms) // 2], "decode_steps": len(step_ms),
                "decode_step_ms_max": step_ms[-1], "generate_s": wall,
                "tokens_per_s": len(prompts) * POLICY_NEW / wall,
                "grow_events": st.grow_events, "freeze_events": st.freeze_events,
                "first_step_after_growth": timer.grown_step,
                "copied_bytes": st.copied_bytes, "allocated_kv_bytes": st.allocated_bytes,
                "live_kv_bytes": live_tokens * per_token, "host_syncs": st.host_syncs,
                "kv_before_growth_mismatches_vs_ggarray": kv_mismatches[policy],
                "greedy_agreement_with_ggarray": agree / (len(prompts) * POLICY_NEW),
                "k14_vs_attend_max_abs_err": attend_err,
                "launches": {k: v for k, v in launches.items() if v}, "ok": True}
        emit(line)
        summary[policy] = line
        runs[policy] = launches
        del eng, out
        torch.cuda.empty_cache()
    exact = {p: compare(first["ggarray"], first[p])[0] for p in ("semistatic", "two_phase")}
    static_err = rel_l2(first["ggarray"], first["static"], V)
    after = {p: rel_l2(grown["ggarray"], grown[p], V) for p in ("semistatic", "two_phase")}
    after["semistatic~two_phase"] = rel_l2(grown["semistatic"], grown["two_phase"], V)
    ok = (max(exact.values()) == 0 and static_err <= ORDER_LOGITS_TOL
          and max(after.values()) <= ORDER_LOGITS_TOL)
    emit({"phase": "serve.policies", "card": card,
          "first_step_logits_mismatches_vs_ggarray": exact,
          "static_first_step_logits_rel_l2_vs_ggarray": static_err,
          "after_growth_logits_rel_l2_vs_ggarray": after, "rel_l2_tolerance": ORDER_LOGITS_TOL,
          "kv_before_growth_mismatches_vs_ggarray": kv_mismatches, "ok": ok})
    check(max(exact.values()) == 0, f"serve.policies: first-step logits differ from ggarray's: {exact}")
    check(static_err <= ORDER_LOGITS_TOL,
          f"serve.policies: static's first-step logits differ by {static_err} (relative L2)")
    check(max(after.values()) <= ORDER_LOGITS_TOL,
          f"serve.policies: logits after the growth differ by {max(after.values())} (relative L2)")
    total = {k: 0 for k in KERNELS}
    for counts in runs.values():
        for k, v in counts.items():
            total[k] += v
    return total


def serve_paths(card: str, seed: int, res: dict) -> tuple:
    """The serving paths, launch counts zeroed before each and read after →
    (the counts summed over the paths, serve.engine's prompt lengths)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 200)
    torch.cuda.reset_peak_memory_stats()
    cfg, params = serve_model(seed)
    eng = serve_engine_path(card, cfg, params, rng, res)
    runs = {"engine": eng["launches"],
            "batch.doubling": serve_batch_path(card, cfg, params, rng, "doubling", BATCH_REQS, res)[0]}
    runs["batch.flat"], flat_prompts, _ = serve_batch_path(card, cfg, params, rng, 1, BATCH_REQS_FLAT, res)
    serve_cross_check(card, cfg, params, eng)
    runs["policies"] = serve_policies_path(card, cfg, params, eng, res)
    runs.update(obs_serve_paths(card, cfg, params, eng["prompts"], flat_prompts))
    r = {k: {n: res[k][n] for n in ("mismatches", "max_abs_err", "cases")}
         for k in ("flash_attention", "push_back_multi", "paged_attend", "paged_attend_extents",
                   "decode_attention")}
    emit({"phase": "serve.captured", "card": card, "kernels": r})
    for name, v in r.items():
        check(v["mismatches"] == 0, f"{name}: the serving run's captured inputs disagree with the plain version")
    emit({"phase": "serve.launches", "card": card, "launches": runs,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    del params
    torch.cuda.empty_cache()
    total = {k: 0 for k in KERNELS}
    for counts in runs.values():
        for k, v in counts.items():
            total[k] += v
    return total, [len(p) for p in eng["prompts"]]


# --------------------------------------------------------------------------
# Phase 6b: the remaining model families (slice 10) at full width with
# random bf16 weights from the seed: MoE routing by the insertion scan (K1,
# K2), dbrx, the Jamba hybrid, Mamba-2, seamless and InternVL2.
# --------------------------------------------------------------------------

# dbrx-132b (src/repro/configs/dbrx_132b.py): d_model 6144, 48 heads over 8
# KV heads of 128, 16 experts top-4 of d_ff 10752, vocab 100352, bf16.  Its
# 40 layers (263 GB) do not fit one card: 8 layers, 27.3e9 parameters, 54.6 GB.
MOE_ARCH, MOE_LAYERS = "dbrx-132b", 8
# moe.route: one dbrx layer on 4 x 1792 tokens (16 experts x 28672 lanes,
# K2's 16-row tiles) and at a decode step of 8 slots (16 x 32).
ROUTE_B, ROUTE_S, ROUTE_DECODE_B, ROUTE_ITERS = 4, 1792, 8, 50
# serve.hybrid / serve.ssm: Engine on 4 equal prompts of 1792 tokens (the
# reference's Engine right-pads a ragged batch through the Mamba
# recurrence), 64 new tokens.  jamba-v0.1-52b and mamba2-2.7b whole.
HYBRID_ARCH, SSM_ARCH, FAMILY_B, FAMILY_LEN, FAMILY_NEW = "jamba-v0.1-52b", "mamba2-2.7b", 4, 1792, 64
# serve.encdec: seamless-m4t-large-v2 whole; 4 x 1024 encoder frames,
# 512-token decoder prompts, 32 decode steps.
ENCDEC_ARCH, ENCDEC_FRAMES, ENCDEC_LEN, ENCDEC_NEW = "seamless-m4t-large-v2", 1024, 512, 32
# serve.vlm: internvl2-26b at full width, 48 layers cut to 4 (run time);
# 256 prefix embeddings + 1536 tokens, 32 decode steps.
VLM_ARCH, VLM_LAYERS, VLM_LEN, VLM_NEW = "internvl2-26b", 4, 1536, 32
# The equivalence checks run the same model in f32: the last decode step
# against forward over the whole sequence (plain blockwise attention, the
# chunked SSD pass), and Engine's prefill logits against BatchEngine's
# chunked prefill, each as the relative L2 of the logits, within the 2e-3
# of tests/test_torch_models.py.  In bf16, rounding alone moves Jamba's
# prefill logits by about 0.12 between two GEMM batchings of the same code
# (Engine on the 4 prompts at once against one by one: serve.hybrid.
# cross_check's engine_batch4_vs_one_by_one, PERF.md), so the bf16 runs
# give the times and print their gaps beside that floor.
FAMILY_TOL = 2e-3
FAMILY_F32 = dict(dtype="float32", param_dtype="float32")
CHECK_NEW = 8  # decode steps of an f32 check run


def family_model(arch: str, seed: int, **over):
    """``arch`` with the TPU-kernel settings (K13 prefill, K10/K11 paged
    decode) and ``over``, random bf16 weights drawn on the card → (cfg,
    params, parameter bytes, seconds to draw them)."""
    import dataclasses

    import torch

    from repro_torch.configs import get
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get(arch), attention_impl="pallas", paged_attend_impl="pallas", **over)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen)
    torch.cuda.synchronize()
    return cfg, params, tree_bytes(params), time.perf_counter() - t0


def tree_bytes(x) -> int:
    if isinstance(x, dict):
        return sum(tree_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(tree_bytes(v) for v in x)
    return x.numel() * x.element_size()


def rel_logits(a, b, V: int) -> float:
    """Relative L2 of two logits blocks over the live vocab columns."""
    a, b = a[..., :V].float(), b[..., :V].float()
    return float(((a - b).norm() / a.norm()).item())


def moe_route_path(card: str, cfg, params, gen, res: dict) -> tuple[dict, dict]:
    """One dbrx MoE layer (period 0's weights) on 4 x 1792 tokens under the
    insertion methods ``scan``, ``tile`` (K1) and ``mxu`` (K2), and at a
    decode step of 8 slots under those and ``atomic``: offsets, slots,
    packed buffers and layer outputs bitwise equal across methods.  K1, K2
    and ``torch.cumsum`` timed on the assignment masks in CUDA-graph
    replays (K2 also from Python), and the routing's time in the layer →
    (launch counts of the driven layers, the phase's line)."""
    import dataclasses

    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.scan_mxu import kernel as k_sm
    from repro_torch.kernels.scan_mxu import ref as r_sm
    from repro_torch.kernels.scan_tile import kernel as k_st
    from repro_torch.kernels.scan_tile import ref as r_st
    from repro_torch.models import moe, transformer

    p = transformer.layer_params(params["layers"][0]["moe"], 0)
    D = cfg.d_model
    shapes = {
        "prefill": (torch.randn((ROUTE_B, ROUTE_S, D), generator=gen, device=DEV).to(torch.bfloat16),
                    ("scan", "tile", "mxu")),
        "decode": (torch.randn((ROUTE_DECODE_B, 1, D), generator=gen, device=DEV).to(torch.bfloat16),
                   ("scan", "atomic", "tile", "mxu")),
    }

    def with_method(m):
        return dataclasses.replace(cfg, insertion_method=m)

    # the driven path: the layer under each method, launch counts around it
    common.reset_launch_counts()
    outs = {(s, m): moe.moe_block(p, x, with_method(m)) for s, (x, ms) in shapes.items() for m in ms}
    torch.cuda.synchronize()
    launches = common.launch_counts()
    for name in ("row_scan", "row_scan_mxu"):
        check(launches[name] >= 2, f"kernel {name} never launched on the moe.route path")

    line = {"phase": "moe.route", "card": card, "arch": cfg.name, "experts": cfg.moe.n_experts,
            "top_k": cfg.moe.top_k, "d_ff_expert": cfg.moe.d_ff_expert}
    mism = 0
    for s, (x, ms) in shapes.items():
        xt = x.reshape(-1, D)
        C = moe.expert_capacity(cfg.moe, xt.shape[0])
        got = {}
        for m in ms:
            c = with_method(m)
            _, gate, expert = moe.route(p, xt, c)
            buf, slot, offsets, assign = moe.pack(xt, expert, c, C)
            out, aux = outs[s, m]
            got[m] = (offsets, slot, buf, out, aux.reshape(1))
        for m in ms[1:]:
            mism += sum(compare(a, b)[0] for a, b in zip(got[m], got["scan"]))
        offsets, slot = got["scan"][:2]
        mask = assign.to(torch.int32)
        rows, cols = mask.shape
        want = torch.cumsum(mask, dim=1, dtype=torch.int32)
        for name, fn, ref in (("row_scan", k_st.row_scan_cuda, r_st.row_scan),
                              ("row_scan_mxu", k_sm.row_scan_mxu_cuda, r_sm.row_scan)):
            r = res[name]
            r["mismatches"] += compare(fn(mask), ref(mask))[0] + compare(fn(mask), want)[0]
            r["cases"] += 1
        bms, by = bound_ms(2 * rows * cols * 4, rows * cols, card)
        # the scans in CUDA-graph replays: at these shapes a launch from
        # Python takes longer than the kernel
        line[s] = {
            "tokens": xt.shape[0], "lanes": cols, "capacity": C,
            "dropped": int((slot < 0).sum().item()), "mask": [rows, cols],
            "k1_ms": graph_ms(lambda: k_st.row_scan_cuda(mask), ROUTE_ITERS),
            "k2_ms": graph_ms(lambda: k_sm.row_scan_mxu_cuda(mask), ROUTE_ITERS),
            "cumsum_ms": graph_ms(lambda: torch.cumsum(mask, dim=1, dtype=torch.int32), ROUTE_ITERS),
            "k2_from_python_ms": cuda_ms(lambda: k_sm.row_scan_mxu_cuda(mask), ROUTE_ITERS),
            "bound_ms": bms, "bound_by": by,
            "route_and_pack_ms": cuda_ms(lambda: moe._route_and_pack(p, xt, with_method("mxu"), C), 10),
            "layer_ms": cuda_ms(lambda: moe.moe_block(p, x, with_method("mxu")), 5),
        }
    line.update({"mismatches_across_methods": mism, "launches": {k: v for k, v in launches.items() if v},
                 "ok": mism == 0})
    emit(line)
    check(mism == 0, f"moe.route: {mism} elements differ between insertion methods")
    del outs, shapes
    torch.cuda.empty_cache()
    return launches, line


def family_engine(card: str, what: str, cfg, params, prompts, new: int, res: dict) -> dict:
    """Engine(policy="ggarray") on ``prompts``, every decode step under the
    sync check; one host sync, no bytes copied, tokens inside the vocab; in
    an attention stack layer 0's K13 and two-group K3 held against their
    plain versions on the captured inputs; the prefill timed on its own →
    the run (outputs, prefill logits, steps, launches, line fields)."""
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import kernel as k_fa
    from repro_torch.kernels.push_back import kernel as k_pb
    from repro_torch.serving import steps
    from repro_torch.serving.engine import Engine

    common.reset_launch_counts()
    eng = Engine(params, cfg, device=DEV)
    with Capture(k_fa, "flash_attention_cuda") as cap_fa, Capture(k_pb, "push_back_cuda_multi") as cap_pb, \
            StepTimer(steps, "decode_step") as timer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompts, new)
        wall = time.perf_counter() - t0
    launches = common.launch_counts()
    st = eng.stats
    check(st.host_syncs == 1, f"{what}: {st.host_syncs} host syncs, expected only the final token drain")
    check(st.copied_bytes == 0, f"{what}: ggarray growth copied bytes")
    for p, o in zip(prompts, out):
        check(len(o) == len(p) + new and o[:len(p)] == p, f"{what}: output length / prompt")
        check(all(0 <= t < cfg.vocab_size for t in o[len(p):]), f"{what}: token outside the vocab")
    if "attn" in cfg.layout:
        for name in ("flash_attention", "push_back_multi"):
            check(launches[name] >= 1, f"kernel {name} never launched on the {what} path")
        check_captured_engine(res, cap_fa, cap_pb)
    del cap_fa, cap_pb, eng
    logits, caches, prefill_s, ttft_s = timed_prefill(params, cfg, prompts)
    check(bool(torch.isfinite(logits).all().item()), f"{what}: prefill logits not finite")
    step_ms = timer.step_ms()
    live = sum(len(p) for p in prompts) + len(prompts) * (new - 1)
    fields = {"prompts": [len(p) for p in prompts], "new_tokens": new, "prefill_s": prefill_s,
              "ttft_s": ttft_s, "prefill_tokens_per_s": sum(len(p) for p in prompts) / prefill_s,
              "decode_step_ms_median": step_ms[len(step_ms) // 2], "decode_steps": len(step_ms),
              "generate_s": wall, "tokens_per_s": len(prompts) * new / wall,
              "grow_events": st.grow_events, "copied_bytes": st.copied_bytes,
              "allocated_kv_bytes": st.allocated_bytes, "live_kv_bytes": live * kv_bytes_per_token(cfg),
              "host_syncs": st.host_syncs, "launches": {k: v for k, v in launches.items() if v}}
    run = {"out": out, "logits": logits.float(), "last_logits": timer.last_logits.float(),
           "launches": launches, "fields": fields}
    del caches
    torch.cuda.empty_cache()
    return run


def batch_prefill_logits(cfg, params, prompts):
    """BatchEngine's chunked prefill of ``prompts``: each one's final-chunk
    logits, (len(prompts), V) f32."""
    import torch

    from repro_torch.serving.engine import BatchEngine

    class Capturing(BatchEngine):
        def _finish_prefill(self, req, slot, lg):
            self.prefill_logits[req.rid] = lg[0].float()
            super()._finish_prefill(req, slot, lg)

    be = Capturing(params, cfg, max_batch=len(prompts), grow_chunk="doubling", device=DEV)
    be.prefill_logits = {}
    be.run_all(prompts, 2)
    got = torch.stack([be.prefill_logits[r] for r in range(len(prompts))])
    del be
    torch.cuda.empty_cache()
    return got


def forward_rel(what: str, cfg, params, out, last_logits, **kw) -> float:
    """The last decode step's logits against ``forward`` over every token
    it had seen (plain blockwise attention: the Pallas tiles need lengths
    that divide by 256) → relative L2."""
    import dataclasses

    import torch

    from repro_torch.models import transformer

    toks = torch.tensor([o[:-1] for o in out], dtype=torch.int32, device=DEV)
    with torch.no_grad():
        logits, _ = transformer.forward(params, toks, dataclasses.replace(cfg, attention_impl="blockwise"),
                                        **kw)
    rel = rel_logits(logits[:, -1], last_logits, cfg.vocab_size)
    check(bool(torch.isfinite(last_logits).all().item()), f"{what}: decode logits not finite")
    del logits
    torch.cuda.empty_cache()
    return rel


def serve_moe_paths(card: str, seed: int, lens, res: dict) -> dict:
    """moe.route, then serve.moe: dbrx-132b at full width, 8 layers,
    ``insertion_method="mxu"``: Engine(ggarray) on serve.engine's prompt
    lengths with 320 new tokens (one growth), BatchEngine over doubling
    extents with serve.batch's requests → launch counts by run."""
    import numpy as np
    import torch

    cfg, params, nbytes, init_s = family_model(MOE_ARCH, seed + 500, n_layers=MOE_LAYERS,
                                               insertion_method="mxu")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 501)
    runs = {}
    runs["moe.route"], route = moe_route_path(card, cfg, params, gen, res)
    rng = np.random.default_rng(seed + 502)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    eng = family_engine(card, "serve.moe.engine", cfg, params, prompts, SERVE_NEW, res)
    check(eng["fields"]["grow_events"] >= 1, "serve.moe: the cache never grew")
    emit({"phase": "serve.moe.engine", "card": card, "arch": cfg.name, "n_layers": cfg.n_layers,
          "param_bytes": nbytes, "init_s": init_s, **eng["fields"], "ok": True})
    runs["moe.engine"] = eng["launches"]
    runs["moe.batch"], _, bline = serve_batch_path(card, cfg, params, rng, "doubling", BATCH_REQS, res,
                                                   what="serve.moe.batch")
    # BatchEngine's K/V writes are plain scatters in both packages (counted
    # as slab_append waves by the counter plane, but K12 is the arena's)
    both = {k: runs["moe.engine"][k] + runs["moe.batch"][k] for k in KERNELS}
    for name in ("row_scan_mxu", "push_back_multi", "flash_attention"):
        check(both[name] >= 1, f"kernel {name} never launched on the serve.moe path")
    check(both["paged_attend"] + both["paged_attend_extents"] >= 1,
          "kernel paged_attend never launched on the serve.moe path")
    # routing's share of a steady BatchEngine decode step: one layer's route
    # and pack at the 8-slot decode shape (moe.route), times the layers
    per_layer = route["decode"]["route_and_pack_ms"]
    emit({"phase": "serve.moe", "card": card, "arch": cfg.name, "n_layers": cfg.n_layers,
          "routing_ms_per_layer": per_layer, "moe_layer_ms": route["decode"]["layer_ms"],
          "steady_step_ms_median": bline["steady_step_ms_median"],
          "routing_share_of_step": per_layer * cfg.n_layers / bline["steady_step_ms_median"],
          "ok": True})
    del params, eng
    torch.cuda.empty_cache()
    return runs


def serve_hybrid_paths(card: str, seed: int, res: dict) -> dict:
    """serve.hybrid: jamba-v0.1-52b whole.  Engine(ggarray) on 4 equal
    prompts, BatchEngine (chunked, doubling) on serve.batch's requests;
    then the two prefills' logits on the equal prompts against each other,
    in f32 (checked) and in bf16 (beside the bf16 rounding floor)."""
    import numpy as np
    import torch

    cfg, params, nbytes, init_s = family_model(HYBRID_ARCH, seed + 600)
    rng = np.random.default_rng(seed + 601)
    prompts = [rng.integers(0, cfg.vocab_size, FAMILY_LEN).tolist() for _ in range(FAMILY_B)]
    eng = family_engine(card, "serve.hybrid.engine", cfg, params, prompts, FAMILY_NEW, res)
    emit({"phase": "serve.hybrid.engine", "card": card, "arch": cfg.name, "n_layers": cfg.n_layers,
          "param_bytes": nbytes, "init_s": init_s, **eng["fields"], "ok": True})
    runs = {"hybrid.engine": eng["launches"]}
    runs["hybrid.batch"] = serve_batch_path(card, cfg, params, rng, "doubling", BATCH_REQS, res,
                                            what="serve.hybrid.batch")[0]
    V = cfg.vocab_size
    bf16 = {"engine_vs_batch": rel_logits(eng["logits"], batch_prefill_logits(cfg, params, prompts), V),
            "engine_batch4_vs_one_by_one": rel_logits(
                eng["logits"], torch.cat([timed_prefill(params, cfg, [p])[0] for p in prompts]), V)}
    del params, eng
    torch.cuda.empty_cache()
    cfg, params, _, _ = family_model(HYBRID_ARCH, seed + 602, **FAMILY_F32)
    logits = timed_prefill(params, cfg, prompts)[0]
    rel = rel_logits(logits, batch_prefill_logits(cfg, params, prompts), V)
    emit({"phase": "serve.hybrid.cross_check", "card": card, "arch": cfg.name,
          "prompts": [len(p) for p in prompts], "f32_logits_rel_l2_err": rel,
          "rel_l2_tolerance": FAMILY_TOL, "bf16_rel_l2": bf16, "ok": rel <= FAMILY_TOL})
    check(rel <= FAMILY_TOL, f"serve.hybrid: f32 prefill logits differ by {rel} (relative L2) > {FAMILY_TOL}")
    del params, logits
    torch.cuda.empty_cache()
    return runs


def serve_ssm_path(card: str, seed: int, res: dict) -> dict:
    """serve.ssm: mamba2-2.7b whole, Engine(ggarray) on 4 x 1792 tokens with
    64 new; the last decode step against forward over the whole sequence,
    in f32 (a run of 8 new tokens, checked) and in bf16."""
    import numpy as np
    import torch

    cfg, params, nbytes, init_s = family_model(SSM_ARCH, seed + 700)
    rng = np.random.default_rng(seed + 701)
    prompts = [rng.integers(0, cfg.vocab_size, FAMILY_LEN).tolist() for _ in range(FAMILY_B)]
    eng = family_engine(card, "serve.ssm", cfg, params, prompts, FAMILY_NEW, res)
    launches = eng["launches"]  # none: the SSD scan is plain PyTorch, as in the reference
    bf16 = forward_rel("serve.ssm", cfg, params, eng["out"], eng["last_logits"])
    fields = eng["fields"]
    del params, eng
    torch.cuda.empty_cache()
    cfg, params, _, _ = family_model(SSM_ARCH, seed + 702, **FAMILY_F32)
    eng = family_engine(card, "serve.ssm.f32", cfg, params, prompts, CHECK_NEW, res)
    rel = forward_rel("serve.ssm", cfg, params, eng["out"], eng["last_logits"])
    emit({"phase": "serve.ssm", "card": card, "arch": cfg.name, "n_layers": cfg.n_layers,
          "param_bytes": nbytes, "init_s": init_s, **fields,
          "f32_last_step_vs_forward_rel_l2": rel, "rel_l2_tolerance": FAMILY_TOL,
          "bf16_last_step_vs_forward_rel_l2": bf16, "ok": rel <= FAMILY_TOL})
    check(rel <= FAMILY_TOL, f"serve.ssm: f32 last decode step differs from forward by {rel}")
    del params, eng
    torch.cuda.empty_cache()
    return {"ssm": launches}


def decode_loop(what: str, cfg, params, toks, new: int, **kw) -> dict:
    """steps.prefill(**kw) then ``new`` greedy decode steps, each under the
    sync check between CUDA events → outputs, the last step's logits, times."""
    import torch

    from repro_torch.serving import steps
    from repro_torch.serving.sampler import sample

    B, S = toks.shape
    P = kw["prefix_embeds"].shape[1] if "prefix_embeds" in kw else 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = steps.prefill(params, toks, cfg, capacity_hint=P + S + new, policy="ggarray", **kw)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = sample(None, logits)
    sampled, events = [tok], []
    length = torch.full((B,), P + S, dtype=torch.int32, device=DEV)
    for _ in range(new):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            a.record()
            logits, caches = steps.decode_step(params, tok, caches, length, cfg)
            b.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        events.append((a, b))
        tok = sample(None, logits)
        sampled.append(tok)
        length = length + 1
    gen = torch.stack(sampled, dim=1).cpu()
    check(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()), f"{what}: token outside the vocab")
    out = [t + g for t, g in zip(toks.cpu().tolist(), gen.tolist())]
    step_ms = sorted(a.elapsed_time(b) for a, b in events)
    del caches
    return {"out": out, "last_logits": logits.float(), "prefill_s": prefill_s,
            "decode_step_ms_median": step_ms[len(step_ms) // 2], "decode_steps": len(step_ms)}


def encdec_run(what: str, cfg, params, gen, new: int) -> dict:
    """``encode`` on 4 x 1024 synthetic frames, prefill with that memory,
    ``new`` decode steps; the last against forward → the run."""
    import torch

    from repro_torch.models import encdec, frontends

    frames = frontends.synthetic_frames(gen, cfg, FAMILY_B, ENCDEC_FRAMES)
    toks = torch.randint(0, cfg.vocab_size, (FAMILY_B, ENCDEC_LEN), generator=gen, device=DEV,
                         dtype=torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    memory = encdec.encode(params["encoder"], frames, cfg)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    run = decode_loop(what, cfg, params, toks, new, memory=memory)
    run["encode_s"] = encode_s
    run["vs_forward"] = forward_rel(what, cfg, params, run.pop("out"), run.pop("last_logits"),
                                    memory=memory)
    return run


def vlm_run(what: str, cfg, params, gen, new: int) -> dict:
    """Prefill with 256 prefix embeddings before 1536 tokens, ``new`` decode
    steps; the last against forward → the run."""
    import torch

    from repro_torch.models import frontends

    prefix = frontends.synthetic_prefix_embeds(gen, cfg, FAMILY_B)
    toks = torch.randint(0, cfg.vocab_size, (FAMILY_B, VLM_LEN), generator=gen, device=DEV,
                         dtype=torch.int32)
    run = decode_loop(what, cfg, params, toks, new, prefix_embeds=prefix)
    run["vs_forward"] = forward_rel(what, cfg, params, run.pop("out"), run.pop("last_logits"),
                                    prefix_embeds=prefix)
    return run


def serve_prompted_path(card: str, seed: int, what: str, arch: str, run_fn, new: int,
                        **over) -> dict:
    """One encoder–decoder or prefix-embedding phase: ``run_fn`` on the bf16
    model (times, launches, the bf16 gap to forward), then on the f32 model
    with ``CHECK_NEW`` steps (the checked gap)."""
    import torch

    from repro_torch.kernels import common

    cfg, params, nbytes, init_s = family_model(arch, seed, **over)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 1)
    common.reset_launch_counts()
    run = run_fn(what, cfg, params, gen, new)
    launches = common.launch_counts()
    for name in ("flash_attention", "push_back_multi"):
        check(launches[name] >= 1, f"kernel {name} never launched on the {what} path")
    del params
    torch.cuda.empty_cache()
    cfg32, params, _, _ = family_model(arch, seed + 2, **over, **FAMILY_F32)
    gen.manual_seed(seed + 1)
    rel = run_fn(what, cfg32, params, gen, CHECK_NEW)["vs_forward"]
    emit({"phase": what, "card": card, "arch": cfg.name, "n_layers": cfg.n_layers,
          "param_bytes": nbytes, "init_s": init_s, "batch": FAMILY_B, "new_tokens": new,
          **{k: v for k, v in run.items() if k != "vs_forward"},
          "f32_last_step_vs_forward_rel_l2": rel, "rel_l2_tolerance": FAMILY_TOL,
          "bf16_last_step_vs_forward_rel_l2": run["vs_forward"],
          "launches": {k: v for k, v in launches.items() if v}, "ok": rel <= FAMILY_TOL})
    check(rel <= FAMILY_TOL, f"{what}: f32 last decode step differs from forward by {rel}")
    del params
    torch.cuda.empty_cache()
    return launches


def family_paths(card: str, seed: int, lens, res: dict) -> dict:
    """Every slice-10 path, launch counts zeroed before each run and read
    after → the counts summed over the runs."""
    import torch

    runs = serve_moe_paths(card, seed, lens, res)
    runs.update(serve_hybrid_paths(card, seed, res))
    runs.update(serve_ssm_path(card, seed, res))
    runs["encdec"] = serve_prompted_path(card, seed + 800, "serve.encdec", ENCDEC_ARCH, encdec_run,
                                         ENCDEC_NEW)
    runs["vlm"] = serve_prompted_path(card, seed + 900, "serve.vlm", VLM_ARCH, vlm_run, VLM_NEW,
                                      n_layers=VLM_LAYERS)
    emit({"phase": "family.launches", "card": card, "launches": runs,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    total = {k: 0 for k in KERNELS}
    for counts in runs.values():
        for k, v in counts.items():
            total[k] += v
    return total


AB_REPS = 5  # prefills a turn, after a warm-up
AB_NEW = 16  # new tokens per BatchEngine request
AB_ORDER = ("parent", "change", "change", "parent")
AB_WHAT = ("prefill", "paged", "batch", "append", "freeze")
AB_DECODE_NEW = 24  # new tokens of the append turn's Engine run


def ab_prefill(seed: int, cfg, params) -> dict:
    """serve.engine's prefill: the median of ``AB_REPS`` after a warm-up,
    then one prefill under ``torch.profiler`` with the device time by
    kernel."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import steps

    rng = np.random.default_rng(seed + 200)
    lens = rng.integers(SERVE_MIN, SERVE_LEN + 1, SERVE_PROMPTS)
    lens[-1] = SERVE_LEN
    toks = np.zeros((SERVE_PROMPTS, SERVE_LEN), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, int(n))
    toks_d, lens_d = torch.from_numpy(toks).to(DEV), torch.from_numpy(lens.astype(np.int32)).to(DEV)

    def prefill():
        steps.prefill(params, toks_d, cfg, capacity_hint=SERVE_LEN, policy="ggarray", lengths=lens_d)
        torch.cuda.synchronize()

    prefill()
    times = []
    for _ in range(AB_REPS):
        t0 = time.perf_counter()
        prefill()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), key=lambda x: -x[1])  # kernels only
    total = sum(t for _, t, _ in kern)
    torch.cuda.empty_cache()
    return {"prefill_s": sorted(times)[len(times) // 2], "prefill_s_all": times,
            "prefill_profiled_wall_ms": wall_ms, "prefill_kernel_ms": total,
            "prefill_device_idle_share": 1 - total / wall_ms,
            "prefill_top": [{"kernel": n[:90], "device_ms": t, "calls": c} for n, t, c in kern[:12]]}


def ab_paged(seed: int) -> dict:
    """The paged kernels at the kernel phase's timed shapes (its input
    builders, drawn from a generator of their own), each without and with
    counters in turns (plain, counted, counted, plain): K8 beside
    ``index_select`` in CUDA-graph replays (and one call from Python each),
    K9 at the freeze's shape beside ``index_select``, the KV view, and
    K10/K11 at the serving shape in CUDA-graph replays."""
    import torch

    from repro_torch.kernels.paged import kernel as k_pg

    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 17)
    payload = make_payload(gen)
    t = {}

    def pair(name, fn, timer, iters):
        t[name], t[name + "_counted"] = _halves(lambda: fn(False), lambda: fn(True), timer, iters)

    pool, pages = k8_inputs(gen, payload)
    idx = pages.clamp(min=0).flatten().long()
    pair("k8_ms", lambda c: k_pg.paged_gather_cuda((pool,), pages, clip_high=True, instrument=c),
         graph_ms, 20)
    t["k8_index_select_ms"] = graph_ms(lambda: pool.index_select(0, idx), 20)
    t["k8_python_ms"] = cuda_ms(lambda: k_pg.paged_gather_cuda((pool,), pages, clip_high=True), 20)
    t["k8_index_select_python_ms"] = cuda_ms(lambda: pool.index_select(0, idx), 20)
    del pool, pages, idx

    exts, _, _, _, elems, mask, pages = k12_inputs(gen, payload)
    del elems, mask
    flat = torch.cat(exts)
    idx = pages.clamp(min=0).flatten().long()
    pair("k9_ms", lambda c: k_pg.paged_gather_cuda(exts, pages, clip_high=False, instrument=c), cuda_ms, 10)
    t["k9_index_select_ms"] = cuda_ms(lambda: flat.index_select(0, idx), 10)
    del flat, exts, pages, idx
    torch.cuda.empty_cache()

    pool, owners, bases, zeros, elems, mask, pages = kv_inputs(gen, payload)
    k_pg.slab_append_cuda((pool,), owners, bases, zeros, elems, mask)
    del elems, mask
    exts, wide = kv_view(pool, pages)
    del pool
    pair("kv_view_ms", lambda c: k_pg.paged_gather_cuda(exts, wide, clip_high=False, instrument=c),
         cuda_ms, 3)
    del exts, wide
    torch.cuda.empty_cache()

    q, pk, pv, pages, lens, _ = serving_attend_inputs(gen)
    for layout, name in (("flat", "k10_ms"), ("doubling", "k11_ms")):
        kx, vx = pool_extents(pk, pv, layout)
        pair(name, lambda c: k_pg.paged_attend_cuda(q, kx, vx, pages, lens, instrument=c), graph_ms, 20)
        del kx, vx
    del q, pk, pv, pages, lens
    torch.cuda.empty_cache()
    return t


def ab_batch(seed: int, cfg, params) -> dict:
    """BatchEngine over doubling extents (K11) on 8 requests of 512-4096
    tokens, ``AB_NEW`` new each: its steady decode steps (CUDA events, no
    prompt pending)."""
    import numpy as np
    import torch

    from repro_torch.serving.engine import BatchEngine

    rng = np.random.default_rng(seed + 17)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(BATCH_MIN, BATCH_MAX + 1, BATCH_SLOTS)]
    be = BatchEngine(params, cfg, max_batch=BATCH_SLOTS, grow_chunk="doubling", device=DEV)
    for p in prompts:
        be.submit(p, AB_NEW)
    _, steady_ev, _ = drive_batch(be)
    torch.cuda.synchronize()
    steps = sorted(a.elapsed_time(b) for a, b in steady_ev)
    del be
    torch.cuda.empty_cache()
    return {"batch_steps": len(steps), "batch_step_ms_median": steps[len(steps) // 2],
            "batch_step_ms": steps}


def ab_append(card: str, seed: int, cfg, params) -> dict:
    """The two append kernels at the kernel phase's timed shapes (its input
    builders, drawn from a generator of their own): K12 on the scalar
    arena's last grow wave and on the KV prefill wave; K3 on the main
    path's last grow wave, without and with counters (plain, counted,
    counted, plain) and in CUDA-graph replays, and on the Engine's decode
    append (two groups, m = 1) in CUDA-graph replays, with and without
    counters, and called once from Python.  Then the paths that run them: the GGArray main path's grow
    (K3) and arena.doubling's grow (K12), eight waves each, and a few
    ``Engine(policy="ggarray")`` decode steps (the two-group K3 in every
    layer)."""
    import numpy as np
    import torch

    from repro_torch.kernels.paged import kernel as k_pg
    from repro_torch.kernels.push_back import kernel as k_pb
    from repro_torch.pool import SlabArena
    from repro_torch.runtime import TwoPhasePipeline
    from repro_torch.serving import steps
    from repro_torch.serving.engine import Engine

    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 19)
    payload = make_payload(gen)
    t = {}
    exts, owners, bases, sizes, elems, mask, _ = k12_inputs(gen, payload)
    t["k12_ms"] = cuda_ms(lambda: k_pg.slab_append_cuda(exts, owners, bases, sizes, elems, mask), 10)
    del exts, owners, bases, sizes, elems, mask
    torch.cuda.empty_cache()
    pool, owners, bases, zeros, elems, mask, _ = kv_inputs(gen, payload)
    t["k12_kv_ms"] = cuda_ms(lambda: k_pg.slab_append_cuda((pool,), owners, bases, zeros, elems, mask), 5)
    del pool, owners, bases, zeros, elems, mask
    torch.cuda.empty_cache()
    levels, elems, mask, sizes = k3_inputs(gen, payload)
    t["k3_ms"], t["k3_counted_ms"] = _halves(
        lambda: k_pb.push_back_cuda(levels, sizes, B0, elems, mask),
        lambda: k_pb.push_back_cuda(levels, sizes, B0, elems, mask, instrument=True), cuda_ms, 10)
    t["k3_graph_ms"] = graph_ms(lambda: k_pb.push_back_cuda(levels, sizes, B0, elems, mask), 5)
    del levels, elems, mask, sizes
    torch.cuda.empty_cache()
    groups, sizes, elems, mask = decode_inputs(gen)
    t["k3_decode_graph_ms"], t["k3_decode_graph_counted_ms"] = _halves(
        lambda: k_pb.push_back_cuda_multi(groups, sizes, SERVE_SLAB, elems, mask),
        lambda: k_pb.push_back_cuda_multi(groups, sizes, SERVE_SLAB, elems, mask, instrument=True),
        graph_ms, 50)
    t["k3_decode_python_ms"] = cuda_ms(lambda: k_pb.push_back_cuda_multi(groups, sizes, SERVE_SLAB, elems, mask), 50)
    del groups, sizes, elems, mask

    rng = np.random.default_rng(seed + 19)
    pipe = TwoPhasePipeline(nblocks=NBLOCKS, b0=B0, device=DEV)
    t["main_grow_s"] = grow(pipe, rng, B0, "auto", card)[1]
    del pipe
    torch.cuda.empty_cache()
    arena = SlabArena(NBLOCKS, B0, dtype=torch.float32, grow_chunk="doubling", device=DEV)
    t["arena_doubling_grow_s"] = grow(TwoPhasePipeline.from_arena(arena), rng, B0, "auto", card)[1]
    del arena
    torch.cuda.empty_cache()

    lens = rng.integers(SERVE_MIN, SERVE_LEN + 1, SERVE_PROMPTS)
    lens[-1] = SERVE_LEN  # the batch pads to it: a multiple of K13's tile, as in serve.engine
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    eng = Engine(params, cfg, device=DEV)
    with StepTimer(steps, "decode_step") as timer:
        eng.generate(prompts, AB_DECODE_NEW)
    step_ms = timer.step_ms()
    t.update(engine_decode_steps=len(step_ms), engine_step_ms_median=step_ms[len(step_ms) // 2],
             engine_step_ms=step_ms)
    del eng
    torch.cuda.empty_cache()
    return t


def ab_freeze(card: str, seed: int) -> dict:
    """K2 on the last grow wave's int32 0/1 mask (from Python and in
    CUDA-graph replays, beside ``torch.cumsum``); K7 on the freeze's plane
    without and with counters (plain, counted, counted, plain);
    ``flatten_segmented`` at the main shape (each kernel's device time under
    ``torch.profiler``); then main.freeze's and main.mxu's grow and freeze
    (eight waves each, method auto and mxu; the freeze's median of three,
    thawed between, and its first).  Entry points that the parent has too."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import indexing
    from repro_torch.kernels.flatten import kernel as k_fl
    from repro_torch.kernels.flatten import ops as fl_ops
    from repro_torch.kernels.scan_mxu import kernel as k_sm
    from repro_torch.runtime import TwoPhasePipeline

    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 20)
    t = {}
    x = (torch.rand((NBLOCKS, B0 << (NWAVES - 1)), generator=gen, device=DEV) < 0.9).to(torch.int32)
    t["k2_ms"] = cuda_ms(lambda: k_sm.row_scan_mxu_cuda(x), 20)
    t["k2_graph_ms"] = graph_ms(lambda: k_sm.row_scan_mxu_cuda(x), 20)
    t["k2_cumsum_ms"] = cuda_ms(lambda: torch.cumsum(x, 1, dtype=torch.int32), 20)
    del x
    levels = tuple(torch.randn((NBLOCKS, w), generator=gen, device=DEV)
                   for w in indexing.bucket_sizes(B0, NWAVES))
    sizes = torch.full((NBLOCKS,), int(0.9 * B0 * (2 ** NWAVES - 1)), dtype=torch.int32, device=DEV)
    sizes += torch.randint(-(B0 // 2), B0 // 2, (NBLOCKS,), generator=gen, device=DEV, dtype=torch.int32)
    starts = indexing.block_starts(sizes)
    ends = starts + sizes
    compact = k_fl.compact_blocks_cuda(levels, B0)
    t["k7_ms"], t["k7_counted_ms"] = _halves(
        lambda: k_fl.segmented_gather_cuda(compact, starts, ends),
        lambda: k_fl.segmented_gather_cuda(compact, starts, ends, instrument=True), cuda_ms, 10)
    del compact
    t["flatten_segmented_ms"] = cuda_ms(lambda: fl_ops.flatten_segmented(levels, sizes, B0), 10)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fl_ops.flatten_segmented(levels, sizes, B0)
        torch.cuda.synchronize()
    kern = {e.key[:90]: e.device_time_total / 1e3 / 5 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}
    t["flatten_segmented_kernels"] = kern
    t["flatten_segmented_k6_k7_ms"] = sum(ms for name, ms in kern.items()
                                          if "compact_kernel" in name or "segmented_gather" in name)
    del levels
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 20)
    for method, key in (("auto", "main"), ("mxu", "mxu")):
        pipe = TwoPhasePipeline(nblocks=NBLOCKS, b0=B0, device=DEV)
        t[f"{key}_grow_s"] = grow(pipe, rng, B0, method, card)[1]
        runs = []
        for i in range(3):
            if i:
                pipe.thaw()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.freeze()
            runs.append(time.perf_counter() - t0)
        t[f"{key}_freeze_s"], t[f"{key}_first_freeze_s"] = sorted(runs)[1], runs[0]
        del pipe
        torch.cuda.empty_cache()
    return t


def ab_turn(card: str, seed: int, what: list) -> dict:
    """One turn of ``--ab``: the timings named in ``what``, with whichever
    checkout's ``repro_torch`` this process imported."""
    t = {"phase": "ab.turn", "card": card}
    if "paged" in what:
        t.update(ab_paged(seed))
    if "freeze" in what:
        t.update(ab_freeze(card, seed))
    if "prefill" in what or "batch" in what or "append" in what:
        cfg, params = serve_model(seed)
        if "prefill" in what:
            t.update(ab_prefill(seed, cfg, params))
        if "batch" in what:
            t.update(ab_batch(seed, cfg, params))
        if "append" in what:
            t.update(ab_append(card, seed, cfg, params))
    return t


def ab_turns(card: str, seed: int, parent: str, what: list) -> None:
    """``--ab PARENT``: :func:`ab_turn` in one process per turn, importing
    the checkout at PARENT's package or this one's (each builds its own
    kernels), in turns (parent, change, change, parent); then each time's
    parent and change means and their ratio.  Reports only: no gate."""
    turns = []
    for turn in AB_ORDER:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--ab", parent,
                               "--what", ",".join(what), "--turn", turn, "--seed", str(seed)],
                              capture_output=True, text=True, timeout=1200)
        check(proc.returncode == 0, f"--ab: the {turn} turn failed:\n{proc.stderr[-3000:]}")
        rec = {**json.loads(proc.stdout.strip().splitlines()[-1]), "turn": turn}
        emit(rec)
        turns.append(rec)
    keys = [k for k, v in turns[0].items() if isinstance(v, float)]
    mean = {w: {k: sum(r[k] for r in turns if r["turn"] == w) / 2 for k in keys}
            for w in ("parent", "change")}
    emit({"phase": "ab", "card": card, "what": what, "order": list(AB_ORDER), "parent": mean["parent"],
          "change": mean["change"],
          "change_over_parent": {k: mean["change"][k] / mean["parent"][k] for k in keys}})


# --------------------------------------------------------------------------
# Phase 7: the device counter plane (K15) — instrumented kernels, arena and
# serving.
# --------------------------------------------------------------------------

def _halves(fn_plain, fn_counted, timer, iters: int) -> tuple[float, float]:
    """Time the plain and the counted launch in turns (plain, counted,
    counted, plain) → (plain ms, counted ms), each the mean of its two."""
    p1 = timer(fn_plain, iters)
    c1 = timer(fn_counted, iters)
    c2 = timer(fn_counted, iters)
    p2 = timer(fn_plain, iters)
    return (p1 + p2) / 2, (c1 + c2) / 2


def obs_kernel_phase(card: str) -> dict:
    """obs.kernels: K3 (one group at the main path's last wave, two groups at
    m = 1), K7 at the freeze's shape, K8/K9 (flat, extents) and K10/K11 at
    the serving shape, plus small ragged cases, each launched with and
    without counters: data outputs bitwise equal, the counter vector
    bitwise equal to the plain twin's (``ref.py``) on the same inputs, both
    times → the ``counter_plane`` entry of the kernels line."""
    import torch

    from repro_torch.core import indexing
    from repro_torch.kernels.flatten import kernel as k_fl
    from repro_torch.kernels.flatten import ops as fl_ops
    from repro_torch.kernels.flatten import ref as r_fl
    from repro_torch.kernels.paged import kernel as k_pg
    from repro_torch.kernels.paged import ref as r_pg
    from repro_torch.kernels.push_back import kernel as k_pb
    from repro_torch.kernels.push_back import ref as r_pb
    from repro_torch.obs import device as obs_device

    dev = torch.device(DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(15)
    rec = {}

    def hold(name, pairs, got_vec, want_vec):
        r = rec.setdefault(name, {"cases": 0, "data_mismatches": 0, "counter_mismatches": 0,
                                  "max_abs_err": 0.0})
        for a, b in pairs:
            r["data_mismatches"] += compare(a, b)[0]
        mism, err = compare(got_vec, want_vec)
        r["counter_mismatches"] += mism
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["cases"] += 1

    def timed(name, plain, counted, timer, iters, shape):
        p, c = _halves(plain, counted, timer, iters)
        rec[name].update(plain_launch_ms=p, counted_ms=c, overhead=c / p - 1.0, shape=shape)

    def k3(n, b0, nlev, m, sizes, item=(), dtype=torch.float32, groups=1, p_live=0.9):
        levels = tuple(tuple(torch.randn((n, w, *item), generator=gen, device=dev).to(dtype)
                             for w in indexing.bucket_sizes(b0, nlev)) for _ in range(groups))
        elems = tuple(torch.randn((n, m, *item), generator=gen, device=dev).to(dtype)
                      for _ in range(groups))
        mask = torch.rand((n, m), generator=gen, device=dev) < p_live
        a, b = clone_tree(levels), clone_tree(levels)
        sa, pa = k_pb.push_back_cuda_multi(a, sizes, b0, elems, mask)
        sb, pb_, blk = k_pb.push_back_cuda_multi(b, sizes, b0, elems, mask, instrument=True)
        pairs = [(sa, sb), (pa, pb_)] + [(x, y) for ga, gb in zip(a, b) for x, y in zip(ga, gb)]
        hold("push_back" if groups == 1 else "push_back_multi", pairs, obs_device.from_block(blk),
             r_pb.counters(mask, sizes, b0, nlev))
        return a, elems, mask

    def k7(compact, sizes):
        starts = indexing.block_starts(sizes)
        ends = starts + sizes
        plain = fl_ops.segmented_gather(compact, starts, ends)
        out, vec = fl_ops.segmented_gather(compact, starts, ends, instrument=True)
        hold("segmented_gather", [(plain, out)], vec, r_fl.gather_counters(starts, ends, *compact.shape))
        return starts, ends

    def k89(exts, pages):
        clip = len(exts) == 1
        plain = k_pg.paged_gather_cuda(exts, pages, clip_high=clip)
        out, blk = k_pg.paged_gather_cuda(exts, pages, clip_high=clip, instrument=True)
        hold("paged_gather" if clip else "paged_gather_extents", [(plain, out)],
             obs_device.from_block(blk), r_pg.gather_counters(pages, sum(e.shape[0] for e in exts), clip))

    def k1011(q, kx, vx, pages, lens):
        plain = k_pg.paged_attend_cuda(q, kx, vx, pages, lens)
        out, blk = k_pg.paged_attend_cuda(q, kx, vx, pages, lens, instrument=True)
        T, KH = kx[0].shape[1], kx[0].shape[2]
        want = r_pg.attend_counters(pages, lens, T, KH, sum(e.shape[0] for e in kx), len(kx) == 1)
        hold("paged_attend" if len(kx) == 1 else "paged_attend_extents", [(plain, out)],
             obs_device.from_block(blk), want)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    # K3 small ragged: one and nine levels, m = 1, 130 and past one
    # 1024-lane chunk, waves past the capacity, an empty mask, two groups
    for n, b0, nlev, m in ((37, 3, 1, 1), (37, 2, 9, 130), (7, 1, 9, 130), (5, 4, 4, 2049)):
        cap = indexing.capacity(b0, nlev)
        for groups in (1, 2):
            for p_live in (0.6, 0.0):
                k3(n, b0, nlev, m, ints(0, cap + 1, (n,)), (2, 8), torch.bfloat16, groups, p_live)
    # K3 at the main path's last grow wave (one group, f32)
    m_last, n_lev = B0 << (NWAVES - 1), NWAVES
    sizes = torch.full((NBLOCKS,), int(0.9 * B0 * (2 ** (NWAVES - 1) - 1)), dtype=torch.int32, device=dev)
    sizes += ints(-(B0 // 4), B0 // 4, (NBLOCKS,))
    la, elems, mask = k3(NBLOCKS, B0, n_lev, m_last, sizes)
    live_lanes = int(mask.sum().item())
    timed("push_back", lambda: k_pb.push_back_cuda_multi(la, sizes, B0, elems, mask),
          lambda: k_pb.push_back_cuda_multi(la, sizes, B0, elems, mask, instrument=True), cuda_ms, 10,
          f"levels {n_lev} x ({NBLOCKS}, {B0}*2^b) f32, wave ({NBLOCKS}, {m_last}), live {live_lanes}")
    k3_bound = bound_ms(NBLOCKS * m_last * (1 + 4 + 4) + 8 * NBLOCKS + 4 * live_lanes,
                        NBLOCKS * m_last, card)
    del la, elems, mask
    # the two-group K3 at the Engine's decode append (m = 1)
    KH, D = 2, 128
    sizes = ints(SERVE_SLAB, 2 * SERVE_SLAB, (SERVE_PROMPTS,))
    groups, elems, mask = k3(SERVE_PROMPTS, SERVE_SLAB, 2, 1, sizes, (KH, D), torch.bfloat16, 2, 1.0)
    timed("push_back_multi", lambda: k_pb.push_back_cuda_multi(groups, sizes, SERVE_SLAB, elems, mask),
          lambda: k_pb.push_back_cuda_multi(groups, sizes, SERVE_SLAB, elems, mask, instrument=True),
          graph_ms, 50, f"2 groups x 2 levels of ({SERVE_PROMPTS}, {SERVE_SLAB}*2^b, {KH}, {D}) bf16, "
                        f"wave ({SERVE_PROMPTS}, 1); CUDA-graph times")
    del groups, elems, mask
    torch.cuda.empty_cache()

    # K7 small ragged: empty blocks, output lengths that are no multiple of
    # the 256-wide tile, every block empty; then the freeze's shape
    for n, b0, nlev in ((7, 3, 5), (40, 4, 4), (1, 1, 1), (64, 2, 2), (3, 128, 2)):
        cap = indexing.capacity(b0, nlev)
        compact = torch.randn((n, cap), generator=gen, device=dev)
        sz = ints(0, cap + 1, (n,))
        sz[::2] = 0
        k7(compact, sz)
        k7(compact, torch.zeros_like(sz))
    cap = indexing.capacity(B0, n_lev)
    final_sizes = torch.full((NBLOCKS,), int(0.9 * B0 * (2 ** NWAVES - 1)), dtype=torch.int32, device=dev)
    final_sizes += ints(-(B0 // 2), B0 // 2, (NBLOCKS,))
    final_sizes[::64] = 0  # a few empty blocks
    compact = torch.randn((NBLOCKS, cap), generator=gen, device=dev)
    starts, ends = k7(compact, final_sizes)
    timed("segmented_gather", lambda: k_fl.segmented_gather_cuda(compact, starts, ends),
          lambda: k_fl.segmented_gather_cuda(compact, starts, ends, instrument=True), cuda_ms, 10,
          f"plane ({NBLOCKS}, {cap}) f32, {int(final_sizes.sum().item())} live")
    del compact
    torch.cuda.empty_cache()

    # K8/K9 small ragged: page -1 and ids past the pool, three layouts
    for layout in ("flat", "doubling", "tz"):
        T, N, P = 5, 7, 6
        sizes_e = _extent_sizes(13, layout)
        S = sum(sizes_e)
        exts = _split(torch.randn((S, T, 8, 128), generator=gen, device=dev).to(torch.bfloat16), sizes_e)
        pages = ints(-1, S, (N, P))
        pages[0, 0], pages[1, 2] = S, S + 9
        k89(exts, pages)
    # the freezes' gathers: a flat 1/8-size pool (K8), doubling extents (K9)
    t8 = B0 // 8
    npages = [-(-int(0.9 * t8 * (2 ** NWAVES - 1) + j) // t8) for j in range(0, 4 * NBLOCKS, 4)]
    S = 2 * sum(npages)
    _, _, pages = _arena_tables(npages, S, t8, gen)
    pool = torch.randn((S, t8), generator=gen, device=dev)
    k89((pool,), pages)
    timed("paged_gather", lambda: k_pg.paged_gather_cuda((pool,), pages, clip_high=True),
          lambda: k_pg.paged_gather_cuda((pool,), pages, clip_high=True, instrument=True), graph_ms, 20,
          f"pages ({NBLOCKS}, {pages.shape[1]}), flat pool {S} x {t8} f32; CUDA-graph times")
    npages = [-(-int(0.9 * B0 * (2 ** NWAVES - 1) + j) // B0) for j in range(0, 4 * NBLOCKS, 4)]
    sizes_e = _extent_sizes(sum(npages), "doubling")
    S = sum(sizes_e)
    _, _, pages = _arena_tables(npages, S, B0, gen)
    exts = _split(torch.randn((S, B0), generator=gen, device=dev), sizes_e)
    k89(exts, pages)
    timed("paged_gather_extents", lambda: k_pg.paged_gather_cuda(exts, pages, clip_high=False),
          lambda: k_pg.paged_gather_cuda(exts, pages, clip_high=False, instrument=True), cuda_ms, 10,
          f"pages ({NBLOCKS}, {pages.shape[1]}) over {len(exts)} extents of {B0} f32")
    del pool, exts, pages
    torch.cuda.empty_cache()

    # K10/K11 small ragged: lengths 0, inside and at a slab's end, a hole
    for layout in ("flat", "doubling", "tz"):
        T, P, G, KH, D = 8, 5, 4, 2, 32
        lengths = [0, 3, 8, 17, 40, 29]
        S = sum(-(-n // T) for n in lengths) + 3
        q, pk, pv, pages, lens = attend_inputs(gen, len(lengths), KH, G, D, T, S, P, torch.float32, lengths)
        pages[4, 1] = -1
        sizes = [n for n in _extent_sizes(S, layout) if n > 0]
        if sum(sizes) > S:
            sizes[-1] -= sum(sizes) - S
        k1011(q, _split(pk, sizes), _split(pv, sizes), pages, lens)
    # the serving shape: q (8, 2, 8, 128) f32 over 2048-token bf16 slabs
    T, KH, G, D, Bq = SERVE_SLAB, 2, 8, 128, BATCH_SLOTS
    lengths = [int(x) for x in torch.randint(BATCH_MIN, BATCH_MAX + BATCH_NEW, (Bq,), generator=gen,
                                             device=DEV).cpu()]
    P = max(-(-n // T) for n in lengths) + 1  # one dead page column per row
    S = sum(-(-n // T) for n in lengths)
    q, pk, pv, pages, lens = attend_inputs(gen, Bq, KH, G, D, T, S, P, torch.bfloat16, lengths)
    for layout, name in (("flat", "paged_attend"), ("doubling", "paged_attend_extents")):
        sizes = [n for n in _extent_sizes(S, layout) if n > 0]
        if sum(sizes) > S:
            sizes[-1] -= sum(sizes) - S
        kx, vx = _split(pk, sizes), _split(pv, sizes)
        k1011(q, kx, vx, pages, lens)
        timed(name, lambda: k_pg.paged_attend_cuda(q, kx, vx, pages, lens),
              lambda: k_pg.paged_attend_cuda(q, kx, vx, pages, lens, instrument=True), graph_ms, 20,
              f"q ({Bq}, {KH}, {G}, {D}) f32, {len(kx)} extent(s) of {T}-token bf16 slabs, "
              f"pages ({Bq}, {P}), {sum(lengths)} live tokens; CUDA-graph times")
        del kx, vx
    del q, pk, pv, pages, lens
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    for name, r in rec.items():
        emit({"phase": "obs.kernels", "name": name, "card": card, **r})
        check(r["data_mismatches"] == 0, f"obs.kernels {name}: counting changed the data outputs")
        check(r["counter_mismatches"] == 0, f"obs.kernels {name}: counters differ from the plain twin's")
    pb = rec["push_back"]
    return {"mismatches": sum(r["counter_mismatches"] for r in rec.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rec.values()),
            "cases": sum(r["cases"] for r in rec.values()),
            "ms": pb["counted_ms"], "plain_ms": pb["plain_launch_ms"], "library_ms": None,
            "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
            "shape": f"K3 at the main path's last wave: {pb['shape']}; ms counted, plain_ms the "
                     f"same launch uncounted; bound: the uncounted K3's (the counters add 76 bytes)",
            "overhead": {name: r["overhead"] for name, r in rec.items() if "overhead" in r}}


def obs_arena_path(card: str, seed: int) -> dict:
    """obs.arena: ``SlabArena(instrument=True)`` at arena.doubling's size,
    grown by the same eight waves: its ``devctr.counters()`` must equal the
    sum of the waves' oracle vectors.  Then a small arena with a refcount
    broken on purpose: ``check_invariants`` raises and writes exactly one
    bundle naming the slab, which ``repro_torch.obs.dump`` reads back."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.paged import ref as r_pg
    from repro_torch.obs import device as obs_device
    from repro_torch.obs import dump as obs_dump
    from repro_torch.obs import flightrec
    from repro_torch.pool import SlabArena

    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 400)
    common.reset_launch_counts()
    arena = SlabArena(NBLOCKS, B0, dtype=torch.float32, grow_chunk="doubling", instrument=True,
                      device=DEV)
    oracle, active, t_grow = [], 0, 0.0
    for w in range(NWAVES):
        m = B0 << w
        vals = torch.randn((NBLOCKS, m), generator=gen, device=DEV)
        mask = torch.rand((NBLOCKS, m), generator=gen, device=DEV) < 0.9
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arena.append(vals, mask)
        torch.cuda.synchronize()
        t_grow += time.perf_counter() - t0
        oracle.append(r_pg.append_counters(mask))
        active += int(mask.sum().item())
        del vals, mask
    launches = common.launch_counts()
    got = arena.devctr.counters()
    want = obs_device.as_dict(torch.stack(oracle).sum(0))
    check(got == want, f"obs.arena: plane {got} != the waves' oracle sum {want}")
    lanes = NBLOCKS * B0 * (2 ** NWAVES - 1)
    check(got["slab_append.waves"] == NWAVES and got["slab_append.lanes"] == lanes,
          "obs.arena: waves or lanes miscounted")
    arena.check_invariants()
    check(arena.flight.last_bundle is None, "obs.arena: a clean arena dumped a bundle")
    del arena
    torch.cuda.empty_cache()

    small = SlabArena(3, 4, initial_slabs=2, instrument=True, device=DEV)
    small.append(torch.arange(6, dtype=torch.float32, device=DEV).reshape(3, 2), np.ones((3, 2), bool))
    small.check_invariants()
    small.alloc.refcount[0] += 1  # engineered corruption
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        old = os.environ.get(flightrec.DIR_ENV)
        os.environ[flightrec.DIR_ENV] = tmp
        try:
            small.check_invariants()
            raised = False
        except AssertionError:
            raised = True
        finally:
            if old is None:
                os.environ.pop(flightrec.DIR_ENV)
            else:
                os.environ[flightrec.DIR_ENV] = old
        bundles = sorted(Path(tmp).glob("flightrec_*.json"))
        check(raised, "obs.arena: check_invariants missed a broken refcount")
        check(len(bundles) == 1, f"obs.arena: {len(bundles)} bundles for one violation")
        b = obs_dump.load_bundle(str(bundles[0]))
        text = obs_dump.summarize(b)
    check(b["reason"] == "refcount_mismatch" and b["state"]["invariant"]["offending_slabs"] == [0],
          f"obs.arena: the bundle does not name slab 0: {b['state'].get('invariant')}")
    check("offending_slabs: [0]" in text, "obs.arena: dump.summarize does not name slab 0")
    emit({"phase": "obs.arena", "card": card, "narrays": NBLOCKS, "slab_size": B0, "waves": NWAVES,
          "grow_s": t_grow, "counters": got, "exact": {"slab_append.waves": NWAVES,
                                                        "slab_append.lanes": lanes,
                                                        "slab_append.active_lanes": active},
          "bundle": {"reason": b["reason"], "offending_slabs": b["state"]["invariant"]["offending_slabs"],
                     "events": len(b["events"]), "summary_lines": len(text.splitlines())},
          "launches": {k: v for k, v in launches.items() if v}, "ok": True})
    return launches


def obs_serve_paths(card: str, cfg, params, engine_prompts, batch_prompts) -> dict:
    """obs.serve: ``Engine`` on serve.engine's prompts and ``BatchEngine`` on
    serve.batch.1's requests (the flat pool, K10), ``OBS_NEW`` new tokens,
    each run without and with ``instrument=True`` in turns (plain, counted,
    counted, plain): the same greedy tokens, K3, slab-append and
    paged-attend counts that match the steps, every decode step (Engine) and
    steady step (BatchEngine) under the sync check → the runs' launch
    counts."""
    import torch

    from repro_torch.kernels import common
    from repro_torch.serving import steps
    from repro_torch.serving.engine import BatchEngine, Engine

    L, runs = cfg.n_layers, {}
    line = {"phase": "obs.serve", "card": card, "arch": SERVE_ARCH, "new_tokens": OBS_NEW,
            "order": list(OBS_ORDER)}
    outs, medians, ctr = [], {"plain": [], "counted": []}, {}
    for n, key in enumerate(OBS_ORDER):
        common.reset_launch_counts()
        eng = Engine(params, cfg, device=DEV, instrument=key == "counted")
        with StepTimer(steps, "decode_step") as timer:  # each step under the sync check
            outs.append(eng.generate(engine_prompts, OBS_NEW))
        runs[f"obs.engine.{n}.{key}"] = launched = common.launch_counts()
        medians[key].append(timer.step_ms()[len(timer.events) // 2])
        if key == "counted":
            ctr = eng.drain_device_counters()
            steps_e = len(timer.events)
            check(ctr["push_back.waves"] == steps_e * L,
                  f"obs.serve engine: K3 waves {ctr['push_back.waves']} != {steps_e} steps x {L} layers")
            check(ctr["push_back.lanes"] == ctr["push_back.active_lanes"] == steps_e * L * len(engine_prompts)
                  and ctr["push_back.padded_lanes"] == 0, "obs.serve engine: K3 lanes miscounted")
            check(launched["push_back_multi"] == launched["counter_plane"] == steps_e * L,
                  f"obs.serve engine: {launched['push_back_multi']} K3 launches, "
                  f"{launched['counter_plane']} counted, expected {steps_e * L} of each")
        del eng
    check(all(o == outs[0] for o in outs), "obs.serve engine: counters changed the tokens")
    line.update(engine_step_ms_median=medians, engine_counters=ctr)
    torch.cuda.empty_cache()

    outs, medians, walls = [], {"plain": [], "counted": []}, {"plain": [], "counted": []}
    for n, key in enumerate(OBS_ORDER):
        common.reset_launch_counts()
        be = BatchEngine(params, cfg, max_batch=BATCH_SLOTS, grow_chunk=1, device=DEV,
                         instrument=key == "counted")
        rids = [be.submit(p, OBS_NEW) for p in batch_prompts]
        out, steady_ev, wall = drive_batch(be)
        runs[f"obs.batch.{n}.{key}"] = launched = common.launch_counts()
        outs.append([out[r] for r in rids])
        torch.cuda.synchronize()
        step_ms = sorted(a.elapsed_time(b) for a, b in steady_ev)
        check(len(step_ms) >= 1, "obs.serve batch: no steady decode step")
        medians[key].append(step_ms[len(step_ms) // 2])
        walls[key].append(wall)
        if key == "counted":
            ctr = be.drain_device_counters()
            decode_steps, chunks = be.stats.decode_steps, be.stats.prefill_chunks
            check(ctr["paged_attend.launches"] == decode_steps * L,
                  f"obs.serve batch: paged_attend.launches {ctr['paged_attend.launches']} != "
                  f"{decode_steps} steps x {L} layers")
            check(launched["paged_attend"] == launched["counter_plane"] == decode_steps * L,
                  f"obs.serve batch: {launched['paged_attend']} K10 launches, "
                  f"{launched['counter_plane']} counted, expected {decode_steps * L} of each")
            check(ctr["slab_append.waves"] == (decode_steps + chunks) * L,
                  "obs.serve batch: slab-append waves do not match the steps and chunks")
        del be
    check(all(o == outs[0] for o in outs), "obs.serve batch: counters changed the tokens")
    line.update(batch_steady_step_ms_median=medians, batch_run_s=walls, batch_counters=ctr,
                batch_decode_steps=decode_steps, batch_prefill_chunks=chunks, ok=True)
    emit(line)
    torch.cuda.empty_cache()
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", metavar="PARENT", default=None,
                    help="only time --what with the checkout at PARENT's package against this "
                         "one's, one process per turn, in turns")
    ap.add_argument("--what", default=",".join(AB_WHAT),
                    help=f"what --ab times, of {','.join(AB_WHAT)}")
    ap.add_argument("--turn", choices=("parent", "change"), default=None,
                    help="with --ab: run one turn in this process and print its times")
    args = ap.parse_args()
    what = [w for w in args.what.split(",") if w]
    if any(w not in AB_WHAT for w in what):
        ap.error(f"--what: expected names of {AB_WHAT}, got {args.what}")
    if args.turn and not args.ab:
        ap.error("--turn needs --ab")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = (Path(args.ab).resolve() if args.turn == "parent" else ROOT) / "src"
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

    if args.turn:
        emit(ab_turn(card, args.seed, what))
        return 0
    if args.ab:
        ab_turns(card, args.seed, args.ab, what)
        return 0

    # 3. kernels against their plain versions
    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)
    res = kernel_phase(card, gen)
    torch.cuda.empty_cache()
    # 3b. each instrumented kernel with and without counters (K15)
    res["counter_plane"].update(obs_kernel_phase(card))
    torch.cuda.empty_cache()

    # 4. main path
    launches = main_path(card, args.seed)
    torch.cuda.empty_cache()

    # 4b. the paper's comparison: main.mxu, baselines, lfvector
    core_launches = slice4_core_paths(card, args.seed)
    torch.cuda.empty_cache()

    # 5. the arena's paths, then the instrumented arena and its flight recorder
    arena_launches = arena_paths(card, args.seed)
    torch.cuda.empty_cache()
    obs_arena_launches = obs_arena_path(card, args.seed)
    torch.cuda.empty_cache()

    # 6. the serving paths
    serve_launches, engine_lens = serve_paths(card, args.seed, res)
    torch.cuda.empty_cache()
    # 6b. the remaining model families
    family_launches = family_paths(card, args.seed, engine_lens, res)
    launches = {k: launches[k] + core_launches[k] + arena_launches[k] + obs_arena_launches[k]
                + serve_launches[k] + family_launches[k] for k in KERNELS}
    check(launches["counter_plane"] >= 1, "kernel counter_plane never launched on the obs paths")

    # 7. the kernels line
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": launches[name], "mismatches": res[name]["mismatches"],
         "tolerance": res[name].get("tolerance", 0.0),
         **({"tolerance_rule": res[name]["tolerance_rule"]} if "tolerance_rule" in res[name] else {}),
         "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
         "plain_ms": res[name]["plain_ms"], "bound_ms": res[name]["bound_ms"],
         "bound_by": res[name]["bound_by"], "library_ms": res[name]["library_ms"],
         "shape": res[name]["shape"], "card": card}
        for name in KERNELS
    ]})
    # 8. the last line
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
