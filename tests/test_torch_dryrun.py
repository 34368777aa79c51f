"""The dry-run of the port (``repro_torch.launch.{specs,dryrun}``) against
the reference's (``repro.launch.{specs,dryrun}``).

- ``plan_cells``: the same 40 cells and skip reasons.
- ``input_specs``: every arch × shape at full size on a (2, 4) mesh, leaf
  for leaf the reference's global shape, dtype and ``PartitionSpec``.  The
  reference runs in a subprocess with eight host devices (``python
  test_torch_dryrun.py ref OUT``), ``jax.eval_shape`` allocating nothing;
  the port builds fake ``DTensor``s on PyTorch's ``fake`` process group of
  eight ranks in this process (destroyed after the module).
- ``count_fn``'s FLOPs on reduced qwen2.5-3b train, prefill and decode cells
  within ``FLOPS_RTOL`` = 1e-6 relative of the reference's ``count_fn`` on the
  same step, and on the same cells under ``--opt`` (``build_cell(opt=True)``
  of each package, at sequences that split the triangular recursion).  One difference is by design: the reference's KV-chunk loop is
  a ``lax.scan``, whose backward recomputes the scores q·kᵀ of every chunk
  (one ``bqkgd,bckd->bqkgc`` product a chunk, layer and microbatch); the
  port's Python loop keeps them for the backward.  The train cell is held
  to the reference's count less that product.
- ``run_cell`` writes the reference's keys, with the renames listed in
  ``launch/dryrun.py``, and the full-size qwen2.5-3b and dbrx decode_32k
  cells reach ``status: ok`` on the 16×16 mesh within ``CELL_S`` = 60 s;
  seamless-m4t's train step, cut to one layer each side, runs its
  backward there; qwen2.5-3b's decode_32k cell at full width and
  ``POD_LAYERS`` layers reaches it on the 2×16×16 mesh, its batch over
  ('pod', 'data').
"""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from repro.launch import specs as rspecs
from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun, specs

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
MESH = (2, 4)
FLOPS_RTOL = 1e-6
CELL_S = 60
POD_LAYERS = 2  # the 2×16×16 decode cell's depth, cut as chip_smoke.py cuts its cells
# reduced cells: (seq, batch); train takes the 8 microbatches of the reference's step
REDUCED = {"train": (64, 8), "prefill": (64, 4), "decode": (64, 4)}
# the --opt cells' reduced shapes: sequences longer than its 2048-token
# chunks, so the triangular recursion splits (train once, prefill twice)
OPT_REDUCED = {"train": (4096, 2), "prefill": (8192, 1), "decode": (64, 4)}
SHAPE_NAMES = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


def _paths(tree, prefix=""):
    """(path, leaf) of a nested dict / list / tuple / NamedTuple, None leaves
    dropped (as ``jax.tree`` drops them)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}/")]
    if hasattr(tree, "_fields"):
        return [p for k in tree._fields for p in _paths(getattr(tree, k), f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)) and type(tree).__name__ != "PartitionSpec":
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _spec_entries(spec, ndim):
    """A PartitionSpec as a list of ndim entries, each None, an axis or a
    list of axes (a one-axis tuple is that axis)."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, (tuple, list)):
            e = list(e) if len(e) > 1 else (e[0] if e else None)
        out.append(e)
    return out


# --------------------------------------------------------------------------
# The reference: eight host devices.
# --------------------------------------------------------------------------

def _ref_main(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax

    from repro import configs as rconfigs
    from repro.configs.base import SHAPES as RSHAPES

    mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    got = {}
    for arch in rconfigs.ARCH_NAMES:
        for shape in RSHAPES:
            try:
                args = rspecs.input_specs(arch, shape, mesh)
            except Exception as e:  # a cell the reference cannot build is listed with its error
                got[f"{arch}|{shape}"] = {"error": f"{type(e).__name__}: {e}"}
                continue
            leaves, _ = jax.tree_util.tree_flatten_with_path(args)
            got[f"{arch}|{shape}"] = {
                "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in path):
                    [list(a.shape), str(a.dtype), _spec_entries(a.sharding.spec, len(a.shape))]
                for path, a in leaves}
    with open(out_path, "w") as f:
        json.dump(got, f)


# --------------------------------------------------------------------------
# The port.
# --------------------------------------------------------------------------

def _port_entry(t):
    """(global shape, dtype name, spec entries) of a port argument leaf."""
    from repro_torch.distributed.context import is_dtensor

    dtype = str(t.dtype).replace("torch.", "")
    if not is_dtensor(t):
        return [list(t.shape), dtype, [None] * t.ndim]
    names = t.device_mesh.mesh_dim_names
    entries = []
    for d in range(t.ndim):
        axes = [names[i] for i, p in enumerate(t.placements) if p.is_shard(d)]
        entries.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return [list(t.shape), dtype, entries]


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref_specs") / "ref.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC)
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, os.path.abspath(__file__), "ref", out],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_specs():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_host_mesh

    got = {}
    with dryrun.fake_world(8):
        dev = dryrun.fake_device()
        mesh = make_host_mesh(*MESH, device=dev)
        with FakeTensorMode(allow_non_fake_inputs=True):
            for arch in configs.ARCH_NAMES:
                for shape in SHAPES:
                    args = specs.input_specs(arch, shape, mesh, device=dev)
                    got[f"{arch}|{shape}"] = {p: _port_entry(t) for p, t in _paths(args)}
    return got


def test_plan_cells_equal_reference():
    got = [(c.arch, c.shape, c.skip_reason, c.name) for c in specs.plan_cells()]
    want = [(c.arch, c.shape, c.skip_reason, c.name) for c in rspecs.plan_cells()]
    assert got == want and len(got) == 40
    assert sum(c.skip_reason is not None for c in specs.plan_cells()) == 8


@pytest.mark.parametrize("shape", list(SHAPES))
def test_input_specs_equal_reference(ref_specs, port_specs, shape):
    bad = {}
    for arch in configs.ARCH_NAMES:
        key = f"{arch}|{shape}"
        want = ref_specs[key]
        assert "error" not in want, (key, want)
        got = port_specs[key]
        if got != want:
            bad[key] = {p: (got.get(p), want.get(p)) for p in set(got) | set(want)
                        if got.get(p) != want.get(p)}
    assert not bad, bad


def _reduced_counts(kind: str):
    """(port count, reference count, reduced config) of one reduced qwen
    cell's step: the port's on a one-rank fake mesh, the reference's on one
    host device."""
    import jax

    from repro import configs as rconfigs
    from repro.analysis import flops as rflops
    from repro.configs.base import ShapeConfig as RShapeConfig
    from repro.distributed.context import activation_mesh as ractivation_mesh
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import flops
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.launch.mesh import make_host_mesh

    seq, batch = REDUCED[kind]
    builders = {"train": "_build_train", "prefill": "_build_prefill", "decode": "_build_decode"}
    rmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rcfg = rconfigs.reduced("qwen2.5-3b")
    fn, args = getattr(rspecs, builders[kind])(rcfg, RShapeConfig(kind, seq, batch, kind), rmesh)
    with rmesh, ractivation_mesh(rmesh):
        want = rflops.count_fn(fn, *args)
    cfg = configs.reduced("qwen2.5-3b")
    with dryrun.fake_world(1):
        dev = dryrun.fake_device()
        mesh = make_host_mesh(1, 1, device=dev)
        with FakeTensorMode(allow_non_fake_inputs=True), activation_mesh(mesh):
            fn, args = getattr(specs, builders[kind])(cfg, ShapeConfig(kind, seq, batch, kind), mesh, dev)
            got = flops.count_fn(fn, *args)
    return got, want, cfg


@pytest.mark.parametrize("kind", list(REDUCED))
def test_count_fn_flops_match_reference(kind):
    got, want, cfg = _reduced_counts(kind)
    expected = want["flops"]
    if kind == "train":  # the reference's scan recomputes q·kᵀ in its backward
        seq, batch = REDUCED[kind]
        chunk = min(cfg.attention_chunk, seq)
        expected -= (cfg.n_layers * 2 * batch * seq * chunk * (seq // chunk)
                     * cfg.n_heads * cfg.head_dim)
    assert abs(got["flops"] - expected) <= FLOPS_RTOL * expected, (got["flops"], want["flops"], expected)
    assert got["hbm_bytes"] > 0 and not got["notes"]


def _opt_counts(kind: str, monkeypatch):
    """(port count, reference count) of one reduced qwen cell under
    ``--opt``: each package's own ``build_cell(opt=True)``, its config and
    shape swapped for the reduced ones (the port's on a one-rank fake
    mesh, the reference's on one host device)."""
    import jax

    from repro import configs as rconfigs
    from repro.analysis import flops as rflops
    from repro.configs.base import ShapeConfig as RShapeConfig
    from repro.distributed.context import activation_mesh as ractivation_mesh
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import flops
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.launch.mesh import make_host_mesh

    seq, batch = OPT_REDUCED[kind]
    name = SHAPE_NAMES[kind]
    rcfg, cfg = rconfigs.reduced("qwen2.5-3b"), configs.reduced("qwen2.5-3b")
    monkeypatch.setattr(rconfigs, "get", lambda arch: rcfg)
    monkeypatch.setattr(configs, "get", lambda arch: cfg)
    monkeypatch.setitem(rspecs.SHAPES, name, RShapeConfig(name, seq, batch, kind))
    monkeypatch.setitem(specs.SHAPES, name, ShapeConfig(name, seq, batch, kind))
    rmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    fn, args, _ = rspecs.build_cell(rspecs.Cell("qwen2.5-3b", name), rmesh, opt=True)
    with rmesh, ractivation_mesh(rmesh):
        want = rflops.count_fn(fn, *args)
    with dryrun.fake_world(1):
        dev = dryrun.fake_device()
        mesh = make_host_mesh(1, 1, device=dev)
        with FakeTensorMode(allow_non_fake_inputs=True), activation_mesh(mesh):
            fn, args, _ = specs.build_cell(specs.Cell("qwen2.5-3b", name), mesh, opt=True, device=dev)
            got = flops.count_fn(fn, *args)
    return got, want


@pytest.mark.parametrize("kind", list(OPT_REDUCED))
def test_count_fn_flops_match_reference_under_opt(kind, monkeypatch):
    """``--opt``: triangular attention in 2048-token chunks (train, prefill),
    the int8 cache (decode), two microbatches (train).  The reference scans
    no KV chunks here (each rectangle is one chunk), so nothing is
    recomputed in its backward: the counts are held equal."""
    got, want = _opt_counts(kind, monkeypatch)
    assert want["flops"] > 0
    assert abs(got["flops"] - want["flops"]) <= FLOPS_RTOL * want["flops"], (got["flops"], want["flops"])
    assert got["hbm_bytes"] > 0 and not got["notes"]


def test_count_fn_counts_a_region_backward_at_every_rank():
    """A ``local_map`` region's ops count once a rank that runs them, in the
    forward and in the backward alike: a product of a batch split over all
    eight ranks of the fake (2, 4) mesh, and its two gradient products,
    come to three times the product's global FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.analysis import flops
    from repro_torch.distributed.context import activation_mesh, as_dtensor, local_region
    from repro_torch.launch.mesh import make_host_mesh

    B, K, N = 64, 32, 16
    with dryrun.fake_world(8):
        mesh = make_host_mesh(*MESH, device=dryrun.fake_device())
        with FakeTensorMode(allow_non_fake_inputs=True), activation_mesh(mesh):
            split = [Shard(0), Shard(0)]
            x = as_dtensor(torch.zeros(B, K), mesh).redistribute(mesh, split).requires_grad_()
            w = as_dtensor(torch.zeros(K, N), mesh).requires_grad_()
            run = local_region(torch.matmul, mesh, (split, [Replicate()] * 2), split)

            def step(x, w):
                run(x, w).sum().backward()

            got = flops.count_fn(step, x, w)
    assert got["flops"] == 3 * 2 * B * K * N, got["flops"]


@pytest.fixture(scope="module")
def decode_cells(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dryrun"))
    out = {}
    for arch in ("qwen2.5-3b", "dbrx-132b"):
        t0 = time.monotonic()
        out[arch] = dryrun.run_cell(specs.Cell(arch, "decode_32k"), multi_pod=False, results_dir=d)
        out[arch]["wall_s"] = time.monotonic() - t0
    return d, out


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "dbrx-132b"])
def test_full_size_decode_cell_ok_on_16x16(decode_cells, arch):
    _, out = decode_cells
    r = out[arch]
    assert r["status"] == "ok", r.get("traceback", r)
    assert r["wall_s"] < CELL_S, r["wall_s"]
    assert r["mesh"] == "16x16" and r["chips"] == 256
    assert r["memory"]["fits_80gb"] and r["memory"]["alias_bytes"] > 0  # the caches, in place
    assert r["roofline"]["bound"] == "memory"  # one token against a 32k cache
    assert r["cost_flop_counter"]["flops"] == r["cost_global"]["flops"]


@pytest.fixture(scope="module")
def pod_decode_cell(tmp_path_factory):
    """qwen2.5-3b × decode_32k on the 2×16×16 mesh at full width, its depth
    cut to ``POD_LAYERS`` as ``chip_smoke.py``'s cut cells are (``configs.get``
    replaced), in a fixture of its own → (run_cell's result, the token
    batch's placement on each mesh dim)."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_production_mesh

    d = str(tmp_path_factory.mktemp("dryrun_pod"))
    full = configs.get
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(configs, "get", lambda name: dataclasses.replace(full(name), n_layers=POD_LAYERS))
        r = dryrun.run_cell(specs.Cell("qwen2.5-3b", "decode_32k"), multi_pod=True, results_dir=d)
        with dryrun.fake_world(512):
            dev = dryrun.fake_device()
            mesh = make_production_mesh(multi_pod=True, device=dev)
            with FakeTensorMode(allow_non_fake_inputs=True):
                _, token, _, _ = specs.input_specs("qwen2.5-3b", "decode_32k", mesh, device=dev)
                batch = {name: repr(p) for name, p in zip(mesh.mesh_dim_names, token.placements)}
    return r, batch


def test_pod_mesh_decode_cell_ok(pod_decode_cell):
    r, _ = pod_decode_cell
    assert r["status"] == "ok", r.get("traceback", r)
    assert r["mesh"] == "2x16x16" and r["chips"] == 512
    assert r["memory"]["fits_80gb"] and r["roofline"]["bound"] == "memory"
    # the model's FLOPs of the depth traced can be no more than the step's
    assert 0 < r["useful_flop_ratio"] <= 1, r["useful_flop_ratio"]


def test_pod_mesh_decode_batch_over_pod_and_data(pod_decode_cell):
    _, batch = pod_decode_cell
    assert batch == {"pod": "Shard(dim=0)", "data": "Shard(dim=0)", "model": "Replicate()"}, batch


def test_run_cell_writes_the_reference_keys(decode_cells):
    d, out = decode_cells
    r = out["qwen2.5-3b"]
    assert set(r) >= {"cell", "arch", "shape", "mesh", "chips", "status", "trace_s", "memory",
                      "cost_flop_counter", "cost_global", "collectives", "roofline", "model_flops",
                      "useful_flop_ratio"}
    assert not set(r) & {"lower_s", "compile_s", "cost_xla_scan_once", "cost_jaxpr_global"}
    # what traced it: DTensor's sharding rules, and so the memory, may differ between them
    assert r["fake_device"] == dryrun.fake_device() and r["torch"] == torch.__version__
    assert set(r["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                                "hbm_used_bytes", "fits_80gb"}
    m = r["memory"]
    assert m["hbm_used_bytes"] == m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"] - m["alias_bytes"]
    assert set(r["cost_global"]) == {"flops", "hbm_bytes"}
    assert set(r["roofline"]) == {"flops_per_device", "bytes_per_device", "collective_bytes_per_device",
                                  "compute_s", "memory_s", "collective_s", "bound", "step_s_lower_bound"}
    assert r["roofline"]["flops_per_device"] == r["cost_global"]["flops"] / 256
    stem = os.path.join(d, "qwen2.5-3b__decode_32k__pod16x16")
    with open(stem + ".json") as f:
        assert json.load(f)["status"] == "ok"
    import gzip

    with gzip.open(stem + ".ops.jsonl.gz", "rt") as f:
        first = json.loads(f.readline())
    assert set(first) == {"op", "shapes", "flops", "bytes"}
    # resumable: a second call reads the file back
    again = dryrun.run_cell(specs.Cell("qwen2.5-3b", "decode_32k"), multi_pod=False, results_dir=d)
    assert again["trace_s"] == r["trace_s"]


def test_encoder_decoder_train_cell_backward_on_16x16(monkeypatch):
    """seamless-m4t-large-v2 × train_4k at full width, one encoder and one
    decoder layer, on the fake 16×16 mesh: the cross-attention's K/V take
    the self-attention's layout, so the backward never meets the memory's
    sequence sharding split into KV chunks (a strided shard DTensor could
    not flatten: the full sweep's error before the fix)."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import flops
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.launch.mesh import make_production_mesh

    full = configs.get
    monkeypatch.setattr(configs, "get", lambda name: dataclasses.replace(full(name), n_layers=1,
                                                                      n_enc_layers=1))
    with dryrun.fake_world(256):
        dev = dryrun.fake_device()
        mesh = make_production_mesh(device=dev)
        with FakeTensorMode(allow_non_fake_inputs=True), activation_mesh(mesh):
            step, args, _ = specs.build_cell(specs.Cell("seamless-m4t-large-v2", "train_4k"), mesh,
                                             device=dev)
            got = flops.count_fn(step, *args)
    assert got["flops"] > 0 and got["collectives"]


def test_skipped_cell_records_its_reason(tmp_path):
    cell = next(c for c in specs.plan_cells() if c.skip_reason)
    r = dryrun.run_cell(cell, multi_pod=True, results_dir=str(tmp_path))
    assert r["status"] == "skipped" and r["skip_reason"] == cell.skip_reason and r["chips"] == 512


if __name__ == "__main__":
    _ref_main(sys.argv[2])
