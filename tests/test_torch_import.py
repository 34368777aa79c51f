"""The port's package boundary: no JAX, no ``repro``, no build at import, and
no quiet CPU fallback."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def _run(code: str, env_extra: dict | None = None) -> str:
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(env_extra or {})
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_every_module_imports_without_jax_or_repro():
    # each module is imported first, into a clean slate of repro_torch
    # modules, so an import cycle that depends on the order shows
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    for k in [k for k in sys.modules if k.split('.')[0] == 'repro_torch']: del sys.modules[k]\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))]\n"
        "print(len(sys.modules), bad)\n"
    )
    out = _run(code)
    assert out.strip().endswith("[]"), out
    assert "repro_torch.runtime.phases" in MODULES and "repro_torch.convert" in MODULES


def test_sources_name_no_jax_and_no_reference_package():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        assert not pat.search(f.read_text()), f"{f} imports jax or repro"


def test_import_needs_no_nvcc_and_builds_nothing():
    code = (
        "import repro_torch.runtime, repro_torch.kernels.flatten.ops, "
        "repro_torch.kernels.push_back.ops, repro_torch.kernels.scan_tile.ops\n"
        "from repro_torch.kernels import _build\n"
        "print(len(_build._loaded))\n"
    )
    out = _run(code, {"PATH": os.path.dirname(sys.executable)})
    assert out.strip() == "0"


def test_entry_points_need_a_card_unless_asked_for_cpu():
    from repro_torch.core import ggarray as gg
    from repro_torch.runtime import TwoPhasePipeline

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TwoPhasePipeline()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gg.init(2)
    assert TwoPhasePipeline(device="cpu").array.device.type == "cpu"


def test_cpu_path_launches_no_kernel():
    from repro_torch.kernels import common
    from repro_torch.runtime import TwoPhasePipeline

    common.reset_launch_counts()
    pipe = TwoPhasePipeline(nblocks=3, b0=2, device="cpu")
    pipe.append(torch.ones((3, 40)), method="auto")  # auto → fused
    pipe.append(torch.ones((3, 5)), method="tile")
    pipe.freeze()
    assert common.launch_counts() == {k: 0 for k in common.KERNELS}


@pytest.mark.parametrize("kind", ["scan_tile", "push_back", "compact", "gather"])
def test_kernel_launchers_refuse_non_cuda_tensors(kind):
    """The CUDA launchers take CUDA tensors only; a non-CPU, non-CUDA tensor
    (``meta``) reaches them through the wrappers and is refused, not run on
    the plain path."""
    from repro_torch.kernels.flatten import ops as fl
    from repro_torch.kernels.push_back import ops as pb
    from repro_torch.kernels.scan_tile import ops as st

    meta = torch.device("meta")
    with pytest.raises(ValueError, match="expected cuda"):
        if kind == "scan_tile":
            st.row_scan(torch.zeros((2, 3), dtype=torch.int32, device=meta))
        elif kind == "push_back":
            levels = (torch.zeros((2, 2), device=meta),)
            pb.push_back_fused(levels, torch.zeros(2, dtype=torch.int32, device=meta), 2,
                               torch.zeros((2, 3), device=meta),
                               torch.ones((2, 3), dtype=torch.bool, device=meta))
        elif kind == "compact":
            fl.compact_blocks((torch.zeros((2, 2), device=meta),), 2)
        else:
            fl.flatten_segmented((torch.zeros((2, 2), device=meta),),
                                 torch.zeros(2, dtype=torch.int32, device=meta), 2)
