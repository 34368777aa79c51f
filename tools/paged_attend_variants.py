#!/usr/bin/env python3
"""Build variants of the paged decode attention (K10/K11,
``src/repro_torch/csrc/paged_attend.cu``) and hold each against the plain
version on one CUDA card.

    python3 tools/paged_attend_variants.py   # from the root of the repository

The variants are the shipped source with text edits, built by ``nvcc`` into
a temporary directory:

- ``tensor_cores``: the source as it is (bf16/f16 pools on ``mma.sync``,
  q and P split into hi + lo 16-bit halves);
- ``cuda_cores``: bf16/f16 pools on the CUDA-core walk of the f32 pools,
  K and V converted exactly to f32 as they leave shared memory;
- ``no_lo`` (a control): the tensor-core walk without the lo halves;
- ``cuda_cores_q16`` (a control): the CUDA-core walk with q rounded to the
  pool's 16-bit type.

Each runs through ``paged_attend_cuda`` on the 16-bit cases of
``chip_smoke.attend_edge_cases`` (D 16-128, G 1-16, bf16 and f16) and on the
serving shape (``chip_smoke.serving_attend_inputs``); a line gives each
variant's largest error against ``ref.attend_paged`` and how many cases fail
``chip_smoke.ATTEND_TOL``.  Then ``tensor_cores`` and ``cuda_cores`` are
timed at the serving shape in CUDA-graph replays, in turns.  Reports only;
it exits non-zero without a card or when a build fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"

# The CUDA-core walk for every pool dtype: fma_walk takes the element type
# and converts 16-bit rows on load; the swizzle, the kernel's choice of walk
# and its G rounding follow the switch.
LOAD_ROW = """// N consecutive 16-bit or f32 elements at p as floats.
template <int N, typename T>
__device__ __forceinline__ void load_row(const T* p, float (&out)[N]) {
  if constexpr (std::is_same<T, float>::value) {
    load_f32<N>(p, out);
  } else {
    constexpr int W = N / 2;
    uint32_t w[W];
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = u.x; w[4 * i + 1] = u.y; w[4 * i + 2] = u.z; w[4 * i + 3] = u.w;
      }
    } else if constexpr (W % 2 == 0) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) {
        const uint2 u = reinterpret_cast<const uint2*>(p)[i];
        w[2 * i] = u.x; w[2 * i + 1] = u.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
      }
    }
  }
}

template <typename T, int D>
struct Chunk {"""
CUDA_CORES = [
    ("template <typename T, int D>\nstruct Chunk {", LOAD_ROW),
    ("  if constexpr (sizeof(T) == 4) {\n    return r * C + c;", "  if constexpr (true) {\n    return r * C + c;"),
    ("template <int D, int GP>\n__device__ __forceinline__ void fma_walk(",
     "template <typename T, int D, int GP>\n__device__ __forceinline__ void fma_walk("),
    ("  using T = float;\n  using Ch = Chunk<T, D>;\n  constexpr int R =", "  using Ch = Chunk<T, D>;\n  constexpr int R ="),
    ("  constexpr int kVec = DPL % 4 == 0 ? 4 : 2;  // floats a load",
     "  constexpr int kMaxVec = 16 / static_cast<int>(sizeof(T));\n"
     "  constexpr int kVec = DPL % kMaxVec == 0 ? kMaxVec : (DPL % 4 == 0 ? 4 : 2);"),
    ("          load_f32<kVec>(krow + x0, kv);", "          load_row<kVec>(krow + x0, kv);"),
    ("            load_f32<kVec>(vrow + x0, vv);", "            load_row<kVec>(vrow + x0, vv);"),
    ("  constexpr bool kMma = sizeof(T) == 2;", "  constexpr bool kMma = false;"),
    ("    fma_walk<D, GP>(q, w, bh, G);", "    fma_walk<T, D, GP>(q, w, bh, G);"),
    ("  if constexpr (sizeof(T) == 2) {  // the tensor-core walk", "  if constexpr (false) {  // the tensor-core walk"),
]
NO_LO = [("            mma_k16<T>(sl[t][rt], ak, bl_[rt][0], bl_[rt][1]);\n", ""),
         ("            mma_k16<T>(acc[md][rt], av, bpl[rt][0], bpl[rt][1]);\n", "")]
Q16 = [("      load_f32<DPL>(q + (bh * G + g) * D + sl * DPL, qr[r]);\n",
        "      load_f32<DPL>(q + (bh * G + g) * D + sl * DPL, qr[r]);\n"
        "      for (int x = 0; x < DPL; ++x) {\n"
        "        if constexpr (std::is_same<T, __nv_bfloat16>::value)\n"
        "          qr[r][x] = __bfloat162float(__float2bfloat16_rn(qr[r][x]));\n"
        "        else if constexpr (std::is_same<T, __half>::value)\n"
        "          qr[r][x] = __half2float(__float2half_rn(qr[r][x]));\n"
        "      }\n")]
VARIANTS = {"tensor_cores": [], "cuda_cores": CUDA_CORES, "no_lo": NO_LO, "cuda_cores_q16": CUDA_CORES + Q16}
TURNS = ("tensor_cores", "cuda_cores", "cuda_cores", "tensor_cores") * 2


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def build(tmp: Path) -> dict:
    """Every variant's library, compiled in parallel → {name: CDLL}."""
    from repro_torch.kernels import _build

    src = (CSRC / "paged_attend.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit's anchor is not in paged_attend.cu once:\n{old}")
            text = text.replace(old, new)
        d = tmp / name
        d.mkdir()
        (d / "paged_attend.cu").write_text(text)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        procs[name] = _build._nvcc(_build.nvcc_path(), d / "paged_attend.cu", d / "libpaged_attend.so")
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-6000:]}")
        lines = log.splitlines()
        regs = [" ".join(x.strip() for x in lines[i + 1:i + 4]) for i in range(len(lines) - 3)
                if "Compiling entry" in lines[i] and "bfloat16Li128ELi8ELb0" in lines[i]]
        emit({"phase": "variant.build", "variant": name, "ptxas_bf16_d128_g8": regs[:1]})
        libs[name] = _build._load(d.parent / name / "libpaged_attend.so")
    return libs


def cases(sms: int):
    """The 16-bit cases of chip_smoke.attend_edge_cases, then the serving shape."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.paged import kernel as k_pg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(118)
    T, P, KH = 64, 20, 2
    for D in (16, 32, 64, 128):
        for G in (1, 4, 8, 16):
            for dtype in (torch.bfloat16, torch.float16):
                ns = k_pg.attend_splits(P, T, 7 * KH, sms)
                lengths = [0, 1, ns - 1, ns, ns + 1, 3 * T, 1000]
                S = sum(-(-n // T) for n in lengths) + 2
                q, pk, pv, pages, lens = cs.attend_inputs(gen, len(lengths), KH, G, D, T, S, P, dtype,
                                                          lengths)
                pages[6, 1] = -1
                yield f"D {D} G {G} {str(dtype).split('.')[-1]}", q, pk, pv, pages, lens
    gen.manual_seed(13)
    yield "serving", *cs.serving_attend_inputs(gen)[:5]


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("paged_attend_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged import kernel as k_pg
    from repro_torch.kernels.paged import ref as r_pg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory(prefix="paged_attend_variants.") as tmp:
        libs = build(Path(tmp))
        err = {n: {"max_abs_err": 0.0, "cases": 0, "cases_over_tol": 0} for n in libs}
        serving = None
        for label, q, pk, pv, pages, lens in cases(sms):
            want = r_pg.attend_paged(q, pk.permute(2, 0, 1, 3), pv.permute(2, 0, 1, 3), pages, lens).double()
            for name, lib in libs.items():
                with _build.use("paged_attend", lib):
                    got = k_pg.paged_attend_cuda(q, (pk,), (pv,), pages, lens).double()
                diff = (got - want).abs()
                r = err[name]
                r["max_abs_err"] = max(r["max_abs_err"], float(diff.max()))
                r["cases"] += 1
                r["cases_over_tol"] += int((diff > cs.ATTEND_TOL * (1 + want.abs())).any())
            if label == "serving":
                serving = (q, pk, pv, pages, lens)
        emit({"phase": "variant.errors", "card": smi, "tolerance": cs.ATTEND_TOL, "variants": err})
        q, pk, pv, pages, lens = serving
        times = {n: [] for n in set(TURNS)}
        for name in TURNS:
            with _build.use("paged_attend", libs[name]):
                times[name].append(cs.graph_ms(lambda: k_pg.paged_attend_cuda(q, (pk,), (pv,), pages, lens), 20))
        mean = {n: sum(v) / len(v) for n, v in times.items()}
        emit({"phase": "variant.times", "card": smi, "order": list(TURNS), "graph_ms": times, "mean_ms": mean,
              "cuda_cores_over_tensor_cores": mean["cuda_cores"] / mean["tensor_cores"],
              "shape": f"q {tuple(q.shape)} f32, bf16 pool of {pk.shape[1]}-token slabs, pages "
                       f"{tuple(pages.shape)}, {int(lens.sum())} live tokens, nsplit "
                       f"{k_pg.attend_splits(pages.shape[1], pk.shape[1], q.shape[0] * q.shape[1], sms)}; "
                       f"CUDA-graph times"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
