#!/usr/bin/env python3
"""Build variants of the freeze's kernels — K2, the tensor-core row scan
(``csrc/scan_mxu.cu``), and K7, the segmented gather (``csrc/flatten.cu``)
— and time each on one CUDA card at the main path's shapes.

    python3 tools/freeze_variants.py [--parent DIR]   # from the root of the repository

The variants are the shipped sources with text edits, built by ``nvcc``
into a temporary directory:

- ``shipped``: the sources as they are (K2: 16 x 1024 tiles, blocks of 8
  warps of 4 chunks, two a SM; K7: 16 KB of output a block, 4-byte loads
  and stores, 8 loads a thread before its stores);
- ``k2_w2048``: K2 on 16 x 2048 tiles, 16 warps of 4 chunks, one block a
  SM (half the chain's hops, but a tile's wait and stores overlap no other
  block's loads on its SM);
- ``k2_w1024_16warps``: K2 on 16 x 1024 tiles, 16 warps of 2 chunks, two
  blocks a SM (64 registers a thread);
- ``k2_w512``: K2 on 16 x 512 tiles, 8 warps of 2 chunks, four blocks a SM;
- ``k7_range8k`` / ``k7_range32k`` / ``k7_range64k``: K7 with 8, 32 or 64
  KB of output a block;
- ``k7_funnel``: K7's copies as 16-byte stores, each lane loading the
  aligned 16 bytes under its output's source and taking the next lane's
  by a shuffle (a funnel shift by the owner's misalignment);
- ``parent``, with ``--parent DIR`` (a checkout of the commit before the
  redesign, as ``chip_smoke.py --ab`` takes it): the parent's K2 in three
  passes (segment totals, carries, scan: x read twice) and its K7 (a
  search an output element, a grid-stride loop; the plane form only).

Each is launched through its library's C entry points with buffers sized
for it, held bitwise against the plain versions (``torch.cumsum``,
``ref.gather_global``; K7's counters against ``ref.gather_counters``),
then timed by ``torch.profiler`` (device ms of each kernel a call
launches) in turns, twice, beside ``x.clone()`` (K2's bytes) and K6 + K7
on the plane (the freeze the levels form replaces).  Reports only; it
exits non-zero without a card, when a build fails or when a variant
disagrees with the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"

FUNNEL = r'''template <typename T>
__device__ __forceinline__ void copy_piece(T* __restrict__ out, int64_t a, int64_t b,
                                           const T* __restrict__ src) {
  constexpr int64_t kV = 16 / sizeof(T);  // items a 16-byte unit
  const int64_t a16 = (a + kV - 1) / kV * kV < b ? (a + kV - 1) / kV * kV : b;
  for (int64_t i = a + threadIdx.x; i < a16; i += kGatherThreads) out[i] = src[i - a];
  const int64_t units = (b - a16) / kV;
  const T* s = src + (a16 - a);
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(s) & 15));  // bytes
  const uint4* base = reinterpret_cast<const uint4*>(reinterpret_cast<uintptr_t>(s) - shift);
  uint4* dst = reinterpret_cast<uint4*>(out + a16);
  for (int64_t u0 = 0; u0 < units; u0 += kGatherThreads) {
    const int64_t u = u0 + threadIdx.x;
    // one past the last unit too: its head is the last unit's tail (an
    // aligned load that holds a byte of the source stays in its allocation)
    const uint4 w0 = u < units + (shift != 0) ? __ldcs(base + u) : make_uint4(0, 0, 0, 0);
    uint4 w1;
    w1.x = __shfl_down_sync(0xffffffffu, w0.x, 1);
    w1.y = __shfl_down_sync(0xffffffffu, w0.y, 1);
    w1.z = __shfl_down_sync(0xffffffffu, w0.z, 1);
    w1.w = __shfl_down_sync(0xffffffffu, w0.w, 1);
    if ((threadIdx.x & 31) == 31 && shift != 0 && u < units) w1 = __ldcs(base + u + 1);
    const unsigned w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    unsigned r[5];
    switch (shift >> 2) {
      case 0: r[0] = w[0]; r[1] = w[1]; r[2] = w[2]; r[3] = w[3]; r[4] = w[4]; break;
      case 1: r[0] = w[1]; r[1] = w[2]; r[2] = w[3]; r[3] = w[4]; r[4] = w[5]; break;
      case 2: r[0] = w[2]; r[1] = w[3]; r[2] = w[4]; r[3] = w[5]; r[4] = w[6]; break;
      default: r[0] = w[3]; r[1] = w[4]; r[2] = w[5]; r[3] = w[6]; r[4] = w[7]; break;
    }
    uint4 v;
    if (shift & 2) {
      v = make_uint4(__funnelshift_r(r[0], r[1], 16), __funnelshift_r(r[1], r[2], 16),
                     __funnelshift_r(r[2], r[3], 16), __funnelshift_r(r[3], r[4], 16));
    } else {
      v = make_uint4(r[0], r[1], r[2], r[3]);
    }
    if (u < units) __stcs(dst + u, v);
  }
  for (int64_t i = a16 + units * kV + threadIdx.x; i < b; i += kGatherThreads) out[i] = src[i - a];
}
'''


def _funnel_edit():
    text = (CSRC / "flatten.cu").read_text()
    start = text.index("template <typename T>\n__device__ __forceinline__ void copy_piece(")
    end = text.index("template <typename T>\n__device__ __forceinline__ void fill_piece(")
    return [("flatten.cu", text[start:end], FUNNEL + "\n")]


def _k2_shape(warps, chunks, min_blocks):
    return [("scan_mxu.cu", "constexpr int kWarps = 8; ", f"constexpr int kWarps = {warps}; "),
            ("scan_mxu.cu", "constexpr int kChunks = 4; ", f"constexpr int kChunks = {chunks}; "),
            ("scan_mxu.cu", "constexpr int kMinBlocks = 2; ", f"constexpr int kMinBlocks = {min_blocks}; ")]


def _range(kb):
    return [("flatten.cu", "constexpr int kRangeBytes = 16384;", f"constexpr int kRangeBytes = {kb * 1024};")]


VARIANTS = {
    "shipped": [],
    "k2_w2048": _k2_shape(16, 4, 1),
    "k2_w1024_16warps": _k2_shape(16, 2, 2),
    "k2_w512": _k2_shape(8, 2, 4),
    "k7_range8k": _range(8),
    "k7_range32k": _range(32),
    "k7_range64k": _range(64),
    "k7_funnel": None,  # _funnel_edit(), read when the variants are built
}
LIBS = ("scan_mxu", "flatten")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def build(tmp: Path, parent: Path | None) -> dict:
    """Every variant's two libraries, compiled in parallel → {name: {lib: CDLL}}."""
    from repro_torch.kernels import _build

    variants = dict(VARIANTS, k7_funnel=_funnel_edit())
    sources = {name: {f: (CSRC / f).read_text() for f in ("common.cuh", "scan_mxu.cu", "flatten.cu")}
               for name in variants}
    for name, edits in variants.items():
        for f, old, new in edits:
            if sources[name][f].count(old) != 1:
                raise RuntimeError(f"{name}: the edit's anchor is not in {f} once:\n{old}")
            sources[name][f] = sources[name][f].replace(old, new)
    if parent is not None:
        old_csrc = parent / "src" / "repro_torch" / "csrc"
        sources["parent"] = {f: (old_csrc / f).read_text() for f in ("common.cuh", "scan_mxu.cu", "flatten.cu")}
    procs = {}
    for name, text in sources.items():
        d = tmp / name
        d.mkdir()
        for f, t in text.items():
            (d / f).write_text(t)
        for lib in LIBS:
            procs[name, lib] = _build._nvcc(_build.nvcc_path(), d / f"{lib}.cu", d / f"lib{lib}.so")
    libs = {name: {} for name in sources}
    for (name, lib), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {lib}:\n{log[-6000:]}")
        regs, entry = {}, None
        for line in log.splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
            elif entry and ("Used" in line or "spill" in line):
                regs.setdefault(entry[:60], []).append(line.split(":", 1)[-1].strip())
        emit({"phase": "variant.build", "variant": name, "lib": lib, "ptxas": regs})
        libs[name][lib] = cdll = _build._load(tmp / name / f"lib{lib}.so")
        c, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        if lib == "scan_mxu":
            cdll.rt_row_scan_mxu.argtypes = [c, c, c, c, i32, i64, i64, c]
            cdll.rt_row_scan_mxu.restype = i32
        else:
            cdll.rt_segmented_gather.argtypes = [c, c, c, c, i64, i64, i32, c, c]
            cdll.rt_segmented_gather.restype = i32
            cdll.rt_compact_blocks.argtypes = [c, i32, c, i64, i64, i32, c]
            cdll.rt_compact_blocks.restype = i32
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of the commit before the redesign")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("freeze_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import indexing
    from repro_torch.kernels import common
    from repro_torch.kernels.flatten import ref as r_fl
    from repro_torch.obs import device as obs_device

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.empty(0, device="cuda").device
    stream = torch.cuda.current_stream(dev).cuda_stream

    def passes(fn, n=5) -> dict:
        """Device ms a call of each kernel ``fn`` launches, over n calls."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return {re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", e.key).split("(")[0][:60]:
                e.device_time_total / 1e3 / n
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    rows, cols = cs.NBLOCKS, cs.B0 << (cs.NWAVES - 1)
    x = (torch.rand((rows, cols), generator=gen, device=dev) < 0.9).to(torch.int32)
    want_scan = torch.cumsum(x, 1, dtype=torch.int32)
    levels = tuple(torch.randn((cs.NBLOCKS, w), generator=gen, device=dev)
                   for w in indexing.bucket_sizes(cs.B0, cs.NWAVES))
    sizes = torch.full((cs.NBLOCKS,), int(0.9 * cs.B0 * (2 ** cs.NWAVES - 1)), dtype=torch.int32, device=dev)
    sizes += torch.randint(-(cs.B0 // 2), cs.B0 // 2, (cs.NBLOCKS,), generator=gen, device=dev,
                           dtype=torch.int32)
    starts = indexing.block_starts(sizes)
    ends = starts + sizes
    plane = torch.cat(levels, 1)
    nblocks, cap = plane.shape
    want_flat = r_fl.gather_global(plane, starts, ends)
    want_ctr = r_fl.gather_counters(starts, ends, nblocks, cap)
    span = obs_device.pack(dev, **{"flatten.span_rows": (ends.long() - starts.long()).sum()})
    ptrs = (ctypes.c_void_p * len(levels))(*(lv.data_ptr() for lv in levels))

    def scan_call(lib, name):
        """One K2 launch with the buffers this build needs → its output."""
        out = torch.empty_like(x)
        if name == "parent":  # three passes: segment totals and carries as scratch
            nseg = -(-cols // 1024)
            a = torch.empty((2, nseg * rows), dtype=torch.int32, device=dev)
            rc = lib.rt_row_scan_mxu(x.data_ptr(), out.data_ptr(), a[0].data_ptr(), a[1].data_ptr(),
                                     0, rows, cols, stream)
        else:
            lib.rt_scan_mxu_tile_cols.restype = ctypes.c_int64
            w = lib.rt_scan_mxu_tile_cols()
            nwords = -(-rows // 16) * (-(-cols // w) - 1) * 16
            status, ticket = bufs.setdefault(name, (torch.zeros(max(nwords, 1), dtype=torch.int64, device=dev),
                                                    torch.zeros(1, dtype=torch.int32, device=dev)))
            rc = lib.rt_row_scan_mxu(x.data_ptr(), out.data_ptr(), status.data_ptr(), ticket.data_ptr(),
                                     0, rows, cols, stream)
        common.check_status(rc, lib, f"row_scan_mxu ({name})")
        return out

    def gather_call(lib, name, levels_form=False, counted=False):
        """One K7 launch on the plane (or the levels) → (output, counter block)."""
        out = torch.empty((nblocks * cap,), dtype=torch.float32, device=dev)
        blk = obs_device.new_block(dev) if counted else None
        ctr = blk.data_ptr() if counted else None
        if levels_form:
            rc = lib.rt_segmented_gather_levels(ptrs, len(levels), cs.B0, starts.data_ptr(), ends.data_ptr(),
                                                out.data_ptr(), nblocks, 4, ctr, stream)
        else:
            rc = lib.rt_segmented_gather(plane.data_ptr(), starts.data_ptr(), ends.data_ptr(),
                                         out.data_ptr(), nblocks, cap, 4, ctr, stream)
        common.check_status(rc, lib, f"segmented_gather ({name})")
        return out, blk

    def k6_then_k7(lib):
        compact = torch.empty_like(plane)
        rc = lib.rt_compact_blocks(ptrs, len(levels), compact.data_ptr(), nblocks, cs.B0, 4, stream)
        common.check_status(rc, lib, "compact_blocks")
        out = torch.empty((nblocks * cap,), dtype=torch.float32, device=dev)
        rc = lib.rt_segmented_gather(compact.data_ptr(), starts.data_ptr(), ends.data_ptr(), out.data_ptr(),
                                     nblocks, cap, 4, None, stream)
        common.check_status(rc, lib, "segmented_gather")

    with tempfile.TemporaryDirectory(prefix="freeze_variants.") as tmp:
        libs = build(Path(tmp), Path(args.parent).resolve() if args.parent else None)
        bufs, bad = {}, []
        for name, vl in libs.items():
            if name != "parent":
                vl["flatten"].rt_segmented_gather_levels.argtypes = [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            ok = {"k2": torch.equal(scan_call(vl["scan_mxu"], name), want_scan)}
            forms = (False,) if name == "parent" else (False, True)
            for lv in forms:
                out, _ = gather_call(vl["flatten"], name, lv)
                out_c, blk = gather_call(vl["flatten"], name, lv, counted=True)
                ok["k7_levels" if lv else "k7"] = (
                    torch.equal(out.view(torch.int32), want_flat.view(torch.int32))
                    and torch.equal(out_c.view(torch.int32), want_flat.view(torch.int32))
                    and torch.equal(obs_device.from_block(blk) + span, want_ctr))
            torch.cuda.synchronize()
            emit({"phase": "variant.check", "variant": name, "bitwise": ok})
            if not all(ok.values()):
                bad.append(name)
        order = list(libs) * 2
        runs = {name: [] for name in libs}
        for name in order:
            vl = libs[name]
            t = {"k2": passes(lambda: scan_call(vl["scan_mxu"], name)),
                 "k7": passes(lambda: gather_call(vl["flatten"], name)),
                 "k7_counted": passes(lambda: gather_call(vl["flatten"], name, counted=True))}
            if name != "parent":
                t["k7_levels"] = passes(lambda: gather_call(vl["flatten"], name, True))
            runs[name].append(t)
        mean = {name: {k: {p: sum(r[k].get(p, 0.0) for r in rs) / len(rs) for p in rs[0][k]}
                       for k in rs[0]} for name, rs in runs.items()}
        emit({"phase": "variant.times", "card": smi, "order": order, "mean_pass_ms": mean,
              "clone_ms": cs.cuda_ms(lambda: x.clone(), 20),
              "cumsum_ms": cs.cuda_ms(lambda: torch.cumsum(x, 1, dtype=torch.int32), 20),
              "k6_then_k7_ms": passes(lambda: k6_then_k7(libs["shipped"]["flatten"])),
              "shape": f"K2: int32 0/1 mask {tuple(x.shape)}; K7: plane {tuple(plane.shape)} f32, "
                       f"{int(sizes.sum())} live"})
    if bad:
        print(f"freeze_variants: {bad} disagree with the plain versions", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
