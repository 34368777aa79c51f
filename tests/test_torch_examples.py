"""Port of the paper's demo configuration (``repro/configs/ggarray_demo.py``)
and the twins of ``examples/*.py`` (``repro_torch.examples``).

Each twin runs on the CPU at its own sizes with its own asserts.  Weights
differ between the packages (``torch.Generator`` against ``PRNGKey``), so a
twin is held to the reference only where nothing depends on them: the
quickstart's printed numbers, every one; the two-phase pipeline's growth
events, capacity, copied bytes and frozen array, bitwise; MoE capacities.
"""
import contextlib
import dataclasses
import importlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ggarray_demo as rdemo
from repro.runtime import TwoPhasePipeline as RefPipeline
from repro_torch.configs import ggarray_demo as demo
from repro_torch.examples import moe_dispatch, quickstart, serve_batched, train_lm, two_phase

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TWINS = ("quickstart", "two_phase", "moe_dispatch", "serve_batched", "train_lm")


def _reference_example(name: str):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args, **kw) -> tuple[str, object]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return buf.getvalue(), out


def _numbers(text: str) -> list[float]:
    """Every number printed, in order, without dtype and device names."""
    text = re.sub(r"dtype=\w+\.\w+|device='[^']*'", "", text)
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", text)]


def test_demo_config_field_for_field():
    ours = [(f.name, f.default) for f in dataclasses.fields(demo.GGArrayDemoConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(rdemo.GGArrayDemoConfig)]
    assert ours == theirs
    assert dataclasses.asdict(demo.CONFIG) == dataclasses.asdict(rdemo.CONFIG)
    assert demo.GGArrayDemoConfig.__dataclass_params__.frozen
    c = demo.CONFIG  # the docstring's reckoning: 1e6 doubled 10 times is 1.024e9
    assert sum(two_phase.duplication_sizes(c.start_size, c.duplications)) == 1_024_000_000


def test_quickstart_prints_the_reference_numbers():
    ours, out = _printed(quickstart.main, device="cpu")
    theirs, _ = _printed(_reference_example("quickstart").main)
    assert _numbers(ours) == _numbers(theirs)
    assert out["alloc"] <= 2 * out["n"] + 4 * 4


def _ref_two_phase(nblocks, sizes, b0, ids):
    pipe = RefPipeline(nblocks, b0=b0, dtype=jnp.int32 if ids else jnp.float32)
    copied, base = 0, 0
    for size in sizes:
        elems, mask, lanes = two_phase.wave(nblocks, size, base, ids, "cpu")
        before = {(b.unsafe_buffer_pointer(), b.nbytes) for b in pipe.array.buckets}
        pipe.append(jnp.asarray(elems.numpy()), None if mask is None else jnp.asarray(mask))
        after = {(b.unsafe_buffer_pointer(), b.nbytes) for b in pipe.array.buckets}
        copied += sum(n for _, n in before - after)
        base += lanes
    frozen = pipe.freeze()
    return pipe, frozen, copied


@pytest.mark.parametrize("ids", [False, True])
def test_two_phase_matches_the_reference_pipeline(ids):
    W = 2
    seen = []
    text, got = _printed(two_phase.main, ids=ids, W=W, device="cpu",
                         check=lambda pipe: seen.append(pipe.frozen.data.clone()))
    nblocks, b0 = 8, (1 << 10) // 8
    sizes = [(1 << 10) << w for w in range(5)]
    pipe, frozen, copied = _ref_two_phase(nblocks, sizes, b0, ids)
    n = int(frozen.size)
    assert got["elements"] == n == sum(sizes)
    assert got["grow_events"] == pipe.stats.grow_events == 4
    assert got["capacity"] == pipe.memory_elems()
    assert got["copied_bytes"] == copied == 0
    assert got["bound_ok"] and got["pipe"].total_size() == n + 16 * nblocks
    # the frozen array after the work phase: the reference's, its live part plus 30·W
    want = np.array(frozen.data)
    want[:n] += 30 * W
    mine = seen[0].numpy()
    assert mine.shape == want.shape and mine.dtype == want.dtype
    assert np.array_equal(mine.view(np.uint32), want.view(np.uint32))
    # the printed line: elements, waves, growth events, capacity, the bound
    first = text.splitlines()[0]
    assert re.search(rf"grow phase: {n} elements in 5 waves, 4 growth events \(copy-free\), "
                     rf"capacity {pipe.memory_elems()} \(≤2x: True\)", first), first


def test_two_phase_at_the_demo_schedule_scaled_down():
    """The §VI schedule (start, then doublings) with the demo's B0 a block,
    at 1/1000 of its start size and 512 blocks: wave sizes that do not
    divide over the blocks, as 1e6 over 512 does not."""
    c = demo.CONFIG
    sizes = two_phase.duplication_sizes(c.start_size // 1000, c.duplications)
    _, got = _printed(two_phase.main, c.nblocks_variants[1], sizes=sizes, b0=c.b0_per_block,
                      W=1, repeats=c.rw_op_repeats, device="cpu")
    assert got["elements"] == 1000 << c.duplications
    assert got["copied_bytes"] == 0 and got["bound_ok"]


def test_moe_dispatch_twin():
    text, got = _printed(moe_dispatch.main, device="cpu")
    from repro import configs as rconfigs
    from repro.models import moe as rmoe

    rmoe_cfg = rconfigs.reduced("dbrx-132b").moe
    assert got["fixed"] == rmoe.expert_capacity(rmoe_cfg, 64)
    assert got["ggarray"] == rmoe.expert_capacity(dataclasses.replace(rmoe_cfg, ggarray_capacity=True), 64)
    assert all(torch.equal(c, got["counts"]["scan"]) for c in got["counts"].values())
    assert got["out_shape"] == (1, 64, 64) and got["load"] <= got["ggarray"]
    assert "unique slots" in text


def test_serve_batched_twin():
    _, got = _printed(serve_batched.main, device="cpu")  # asserts identical tokens and the bound
    assert got["stats"]["ggarray"]["copied_bytes"] == 0
    assert got["stats"]["semistatic"]["copied_bytes"] > 0


def test_train_lm_twin(tmp_path):
    _, out = _printed(train_lm.main, model_size="2m", steps=30, batch=4, seq=64,
                      ckpt_dir=str(tmp_path), device="cpu")  # asserts a falling loss
    assert out["start_step"] == 0 and len(out["losses"]) == 30


def test_importing_a_twin_runs_nothing():
    code = "".join(f"import repro_torch.examples.{n}\n" for n in TWINS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0 and out.stdout == "", out.stderr


@pytest.mark.parametrize("name", TWINS)
def test_twins_need_a_card_unless_asked_for_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main()
