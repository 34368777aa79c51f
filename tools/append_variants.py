#!/usr/bin/env python3
"""Build variants of the two append kernels (K3, ``csrc/push_back.cu``; K12,
``csrc/paged.cu``; both on the row scan of ``csrc/common.cuh``) and time
each pass on one CUDA card.

    python3 tools/append_variants.py   # from the root of the repository

The variants are the shipped sources with text edits, built by ``nvcc``
into a temporary directory:

- ``shipped``: the sources as they are;
- ``scan_uncapped``: K12's scan pass without its register cap
  (``__launch_bounds__(NT)`` alone: 64 registers, four 256-thread blocks a
  SM, against 40 and six);
- ``early_counts``: warp 0 loads the earlier tiles' counts beside the mask
  bytes, before the scan's first barrier, not after it (both kernels);
- ``copy_256``: K12's copy in blocks of 256 threads, not 128;
- ``copy_warp_search``: K12's copy finds its slab's extent by one warp's
  round of loads (lane e tests extent e, then a ballot) in place of the
  binary search of ``common.cuh::slab_address``, a chain of dependent
  loads;
- ``k3_unit_loop``: K3 copies one-unit items through its shared-memory
  unit loop, not directly from registers.

Each is held bitwise against the plain versions at the main shapes
(``chip_smoke.k3_inputs``, ``chip_smoke.k12_inputs``), then every pass is
timed by ``torch.profiler`` at those shapes, the variants in turns, twice,
beside ``mask.to(torch.int32)`` (the scan pass's bytes: the wave's mask
read, an int32 a lane written).  Reports only; it exits non-zero without a
card, when a build fails or when a variant disagrees with the plain
version.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"

EARLY_COUNTS = [
    ("common.cuh",
     "  unsigned char byte[kScanPer];\n",
     "  int pre = 0;  // warp 0: the earlier tiles' counts, loaded beside the mask\n"
     "  if (warp == 0 && counts_row != nullptr)\n"
     "    for (int t = lane; t < tile; t += 32) pre += counts_row[t];\n"
     "  unsigned char byte[kScanPer];\n"),
    ("common.cuh",
     "    int pre = 0;  // the earlier tiles' counts\n"
     "    if (counts_row != nullptr)\n"
     "      for (int t = lane; t < tile; t += 32) pre += counts_row[t];\n",
     ""),
]
WARP_SEARCH = """__device__ __forceinline__ char* slab_address_warp(const int64_t* __restrict__ tbl, int next,
                                                   int64_t s, int64_t slab_bytes) {
  const int64_t* start = tbl + next;
  const int lane = threadIdx.x & 31;
  int e = 0;
  for (int base = 0; base < next; base += 32) {
    const int c = base + lane;
    const uint32_t hit = __ballot_sync(0xffffffffu, c < next && start[c] <= s && s < start[c + 1]);
    if (hit != 0) {
      e = base + __ffs(hit) - 1;
      break;
    }
  }
  return reinterpret_cast<char*>(tbl[e]) + (s - start[e]) * slab_bytes;
}

"""
VARIANTS = {
    "shipped": [],
    "scan_uncapped": [("paged.cu", "__launch_bounds__(NT, 1536 / NT)", "__launch_bounds__(NT)")],
    "early_counts": EARLY_COUNTS,
    "copy_256": [("paged.cu", "constexpr int kCopyThreads = 128;", "constexpr int kCopyThreads = 256;")],
    "copy_warp_search": [("paged.cu", "slab_address(tbl, next, s, slab_size", "slab_address_warp(tbl, next, s, slab_size"),
                         ("common.cuh", "// K15 — the device counter plane.", WARP_SEARCH + "// K15 — the device counter plane.")],
    "k3_unit_loop": [("push_back.cu", "switch (direct ? t.unit[0] : 0)", "switch (0)")],
}
LIBS = ("push_back", "paged")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def build(tmp: Path) -> dict:
    """Every variant's two libraries, compiled in parallel → {name: {lib: CDLL}}."""
    from repro_torch.kernels import _build

    procs = {}
    for name, edits in VARIANTS.items():
        d = tmp / name
        d.mkdir()
        text = {f: (CSRC / f).read_text() for f in ("common.cuh", "push_back.cu", "paged.cu")}
        for f, old, new in edits:
            if text[f].count(old) != 1:
                raise RuntimeError(f"{name}: the edit's anchor is not in {f} once:\n{old}")
            text[f] = text[f].replace(old, new)
        for f, t in text.items():
            (d / f).write_text(t)
        for lib in LIBS:
            procs[name, lib] = _build._nvcc(_build.nvcc_path(), d / f"{lib}.cu", d / f"lib{lib}.so")
    libs = {name: {} for name in VARIANTS}
    for (name, lib), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {lib}:\n{log[-6000:]}")
        regs, entry = {}, None
        for line in log.splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
            elif entry and "Used" in line:
                for key, pat in (("slab_scan<256>", "slab_scan_kernelILi256E"),
                                 ("slab_copy<u32>", "slab_copy_kernelIjE"),
                                 ("push_back<256, u32>", "push_back_kernelILi256EjLb0E"),
                                 ("push_back<256, unit loop>", "push_back_kernelILi256EvLb0E")):
                    if pat in entry:
                        regs[key] = line.split(":", 1)[1].strip()
        emit({"phase": "variant.build", "variant": name, "lib": lib, "ptxas": regs})
        libs[name][lib] = _build._load(tmp / name / f"lib{lib}.so")
    return libs


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("append_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged import kernel as k_pg
    from repro_torch.kernels.paged import ref as r_pg
    from repro_torch.kernels.push_back import kernel as k_pb
    from repro_torch.kernels.push_back import ref as r_pb

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    def passes(fn, n=5) -> dict:
        """Device ms a call of each kernel ``fn`` launches, over n calls."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return {re.sub(r"^void (\(anonymous namespace\)::)?", "", e.key).split("(")[0]: e.device_time_total / 1e3 / n
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    payload = cs.make_payload(gen)
    exts, owners, bases, sizes12, elems12, mask12, _ = cs.k12_inputs(gen, payload)
    want12 = r_pg.slab_append(torch.cat(exts)[:, :, None], owners, bases, sizes12, elems12[:, :, None], mask12)
    levels, elems3, mask3, sizes3 = cs.k3_inputs(gen, payload)
    want_levels = tuple(x.clone() for x in levels)
    _, want_s3, want_p3 = r_pb.push_back(want_levels, sizes3, cs.B0, elems3, mask3)

    def k12():
        return k_pg.slab_append_cuda(exts, owners, bases, sizes12, elems12, mask12)

    def k3():
        return k_pb.push_back_cuda(levels, sizes3, cs.B0, elems3, mask3)

    def using(libs):
        stack = contextlib.ExitStack()
        for lib, cdll in libs.items():
            stack.enter_context(_build.use(lib, cdll))
        return stack

    with tempfile.TemporaryDirectory(prefix="append_variants.") as tmp:
        libs = build(Path(tmp))
        bad = []
        for name, vl in libs.items():
            with using(vl):
                work = tuple(e.clone() for e in exts)
                ns, pos = k_pg.slab_append_cuda(work, owners, bases, sizes12, elems12, mask12)
                ok12 = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in
                           ((torch.cat(work)[:, :, None], want12[0]), (ns, want12[1]), (pos, want12[2])))
                lv = tuple(x.clone() for x in levels)
                ns3, pos3 = k_pb.push_back_cuda(lv, sizes3, cs.B0, elems3, mask3)
                ok3 = torch.equal(ns3, want_s3) and torch.equal(pos3, want_p3) and all(
                    torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(lv, want_levels))
            emit({"phase": "variant.check", "variant": name, "k12_bitwise": ok12, "k3_bitwise": ok3})
            if not (ok12 and ok3):
                bad.append(name)
            del work, lv
        order = list(VARIANTS) * 2
        runs = {name: [] for name in VARIANTS}
        for name in order:
            with using(libs[name]):
                runs[name].append({"k12": passes(k12), "k3": passes(k3)})
        mean = {}
        for name, rs in runs.items():
            mean[name] = {k: {p: sum(r[k][p] for r in rs) / len(rs) for p in rs[0][k]} for k in ("k12", "k3")}
        emit({"phase": "variant.times", "card": smi, "order": order, "mean_pass_ms": mean,
              "mask_to_int32_ms": cs.cuda_ms(lambda: mask12.to(torch.int32), 20),
              "shape": f"K12: wave {tuple(mask12.shape)} f32 into {sum(e.shape[0] for e in exts)} slabs of "
                       f"{cs.B0}; K3: wave {tuple(mask3.shape)} f32 into {len(levels)} levels"})
    if bad:
        print(f"append_variants: {bad} disagree with the plain versions", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
