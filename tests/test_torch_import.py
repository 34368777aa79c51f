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
    assert {"repro_torch.pool.arena", "repro_torch.kernels.paged.ops",
            "repro_torch.data.packing"} <= set(MODULES)
    assert {"repro_torch.configs.registry", "repro_torch.models.transformer",
            "repro_torch.kernels.flash_attention.ops", "repro_torch.serving.kvcache",
            "repro_torch.serving.engine", "repro_torch.obs.timeline",
            "repro_torch.launch.serve"} <= set(MODULES)
    assert {"repro_torch.optim.adamw", "repro_torch.optim.compression",
            "repro_torch.optim.schedule", "repro_torch.train.step", "repro_torch.train.loop",
            "repro_torch.checkpoint.ckpt", "repro_torch.launch.train",
            "repro_torch.tree"} <= set(MODULES)


def test_sources_name_no_jax_and_no_reference_package():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        assert not pat.search(f.read_text()), f"{f} imports jax or repro"


def test_import_needs_no_nvcc_and_builds_nothing():
    code = (
        "import repro_torch.runtime, repro_torch.kernels.flatten.ops, "
        "repro_torch.kernels.push_back.ops, repro_torch.kernels.scan_tile.ops, "
        "repro_torch.kernels.paged.ops, repro_torch.pool, repro_torch.data, "
        "repro_torch.kernels.flash_attention.ops, repro_torch.serving.engine, "
        "repro_torch.launch.serve\n"
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


def test_arena_entry_points_need_a_card_unless_asked_for_cpu():
    from repro_torch.data import Packer
    from repro_torch.pool import SlabArena, init_extent_pool
    from repro_torch.pool.arena import init_pool

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for make in (lambda: SlabArena(2, 4), lambda: init_extent_pool(2, 4),
                 lambda: init_pool(2, 4), lambda: Packer(backend="arena")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert SlabArena(2, 4, device="cpu").pool.free.device.type == "cpu"


def test_cpu_arena_path_launches_no_kernel():
    from repro_torch.kernels import common
    from repro_torch.pool import SlabArena
    from repro_torch.runtime import TwoPhasePipeline

    common.reset_launch_counts()
    for grow_chunk in (1, "doubling"):
        pipe = TwoPhasePipeline.from_arena(SlabArena(3, 2, grow_chunk=grow_chunk, device="cpu"))
        for _ in range(3):
            pipe.append(torch.ones((3, 5)))
        pipe.freeze()
        pipe.arena.logical_view()
    assert common.launch_counts() == {k: 0 for k in common.KERNELS}
    assert {"paged_gather", "paged_gather_extents", "slab_append"} <= set(common.KERNELS)


def test_baseline_entry_points_need_a_card_unless_asked_for_cpu():
    from repro_torch.core import LFVector, SemiStaticArray, static_init

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for make in (lambda: LFVector.create(), lambda: static_init(4),
                 lambda: SemiStaticArray.create(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert static_init(4, device="cpu").data.device.type == "cpu"



@pytest.mark.parametrize("entry", ["init_cache", "init_decode_caches", "Engine", "BatchEngine"])
def test_serving_entry_points_need_a_card_unless_asked_for_cpu(entry):
    from repro_torch.configs import reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import kvcache, steps
    from repro_torch.serving.engine import BatchEngine, Engine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = reduced("qwen2.5-3b", cache_b0=8)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    def first(cache):  # a tensor of the cache slot
        return next(iter(cache.values()))

    make = {
        "init_cache": lambda **kw: first(kvcache.init_cache(cfg, 2, 9, "ggarray", **kw)),
        "init_decode_caches": lambda **kw: first(steps.init_decode_caches(cfg, 2, 9, **kw)[0]),
        "Engine": lambda **kw: Engine(params, cfg, **kw),
        "BatchEngine": lambda **kw: BatchEngine(params, cfg, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu").device.type == "cpu"

def test_cpu_slice4_paths_launch_no_kernel():
    from repro_torch.core import LFVector, static_init, static_push_back
    from repro_torch.kernels import common
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.dispatch_mxu import ops as dm
    from repro_torch.runtime import TwoPhasePipeline

    common.reset_launch_counts()
    pipe = TwoPhasePipeline(nblocks=3, b0=2, flatten_impl="dispatch", device="cpu")
    pipe.append(torch.ones((3, 5)), method="mxu")
    pipe.freeze()
    LFVector.create(b0=2, device="cpu").push_back(torch.ones(5), method="mxu")
    static_push_back(static_init(8, device="cpu"), torch.ones(3), method="mxu")
    dm.combine(torch.ones((4, 2)), torch.tensor([0, -1, 3], dtype=torch.int32))
    da.decode_attention(torch.ones((1, 4, 16)), torch.ones((1, 2, 8, 16)), torch.ones((1, 2, 8, 16)),
                        torch.tensor([5]))
    assert common.launch_counts() == {k: 0 for k in common.KERNELS}


@pytest.mark.parametrize("entry", ["init_train_state", "loop.run", "launch.train"])
def test_training_entry_points_need_a_card_unless_asked_for_cpu(entry, tmp_path):
    from repro_torch.configs import reduced
    from repro_torch.launch import train as launch_train
    from repro_torch.train import loop, step

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = reduced("qwen2.5-3b")
    make = {
        "init_train_state": lambda **kw: step.init_train_state(0, cfg, **kw).params["embed"],
        "loop.run": lambda **kw: loop.run(cfg, loop.LoopConfig(steps=1, batch=2, seq=8), **kw),
        "launch.train": lambda **kw: launch_train.main(
            ["--steps", "1", "--batch", "2", "--seq", "8"]
            + (["--device", kw["device"]] if kw else [])),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    out = make(device="cpu")
    if entry == "init_train_state":
        assert out.device.type == "cpu" and out.requires_grad
    else:
        assert len(out["losses"]) == 1
