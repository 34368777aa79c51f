"""Build and load the port's CUDA kernels: ``nvcc`` → shared library → ``ctypes``.

Each ``csrc/*.cu`` file is one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds, not minutes).  All sources are
compiled at once, one ``nvcc`` process each, on the first kernel launch of
the process — ``import repro_torch`` never builds or loads anything.  The
outputs go to ``build/repro_torch/<key>/`` at the repo root, where ``key``
hashes every source, header and flag, so a changed source rebuilds.  A
failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_all", "library", "nvcc_path"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``,
    else ``nvcc`` on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _key()


def build_all() -> dict:
    """Compile every missing library in parallel → {"seconds", "built", "log"}.

    ``log`` maps each library built now to nvcc's output (``-Xptxas -v``
    register and shared-memory use).  Already-built libraries are skipped.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sorted(CSRC.glob("*.cu")) if not (out / f"lib{s.stem}.so").exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = nvcc_path()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = {}, []
    for src, tmp, proc in procs:
        text, _ = proc.communicate()
        log[src.stem] = text
        if proc.returncode != 0:
            failed.append(f"--- nvcc {src.name} (exit {proc.returncode}) ---\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / f"lib{src.stem}.so")  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": [s.stem for s in todo], "log": log}


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds all on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_dir() / f"lib{name}.so"
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib
