"""Serving on a device mesh: the port's prefill and decode steps on eight
gloo ranks of a (2, 4) ('data', 'model') mesh against the reference's
steps on its eight host devices.

In the pattern of ``tests/test_torch_distributed.py``: the file is its own
worker script.  ``python test_torch_sharded_serving.py ref DIR`` runs the
reference with eight host devices (its own ``XLA_FLAGS``) and writes its
parameters, tokens, logits and gathered caches under DIR;
``... port DIR`` spawns eight gloo ranks (a ``FileStore`` in DIR) that
place the same parameters on the mesh (``convert.params_from_numpy(mesh=)``),
run the same prefill and greedy decode on ``DTensor``s, and write what they
got, and the same run on plain tensors.  The pytest process initialises no
process group.

Cases: reduced qwen2.5-3b with ``cache_b0=8`` (every level divides over
'model'), with and without ``cache_quant``; reduced dbrx (prefill through
``_moe_sharded``, decode through ``_moe_local`` on DTensors); reduced
mamba2 (conv and SSD states sharded on channels and heads).

Tolerances (f32 on the CPU):
- prefill logits within ``LOGITS_TOL`` = 1e-4 max abs of the reference's
  on its mesh (measured: at most 7.4e-7), and the K/V a cache stores
  within the same bound (measured: at most 1.3e-5, mamba2's SSD state);
  an int8 cache's bf16 scales within it too and its codes within one code
  (a value on a rounding boundary, which f32 noise tips either way;
  measured: one code of the v levels off by one, the rest equal);
- the caches' level sizes and written positions, and the greedy tokens
  of 8 decode steps: equal to the reference's mesh run;
- against the port's own unmeshed run: the same tokens, except reduced
  dbrx, whose sharded prefill routes each shard's tokens at the
  shard-local capacity (``_moe_sharded``, as the reference's does), so
  its drops, and with them its tokens, differ from a one-device run by
  design; it is held to the reference's mesh run alone.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

MESH = (2, 4)
BATCH, SEQ, NEW = 4, 16, 8
LOGITS_TOL = 1e-4
TOKEN_SEED = 3
# name → (arch, cache_quant)
CASES = {
    "qwen": ("qwen2.5-3b", False),
    "qwen_int8": ("qwen2.5-3b", True),
    "dbrx": ("dbrx-132b", False),
    "mamba2": ("mamba2-2.7b", False),
}


def _overrides(arch: str, quant: bool) -> dict:
    kw = {"cache_quant": True} if quant else {}
    if arch != "mamba2-2.7b":
        kw["cache_b0"] = 8
    return kw


def _flatten(tree, prefix=""):
    """A parameter or cache tree → {'a/b/0/c': leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if type(tree) in (list, tuple):  # a PartitionSpec is a leaf
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


# --------------------------------------------------------------------------
# The reference: eight host devices.
# --------------------------------------------------------------------------

def _ref_main(d: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro import configs
    from repro.distributed import sharding as sh
    from repro.distributed.context import activation_mesh
    from repro.models import transformer
    from repro.serving import steps

    assert jax.device_count() == 8, jax.device_count()
    mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    meta = {}
    for name, (arch, quant) in CASES.items():
        cfg = configs.reduced(arch, **_overrides(arch, quant))
        params = transformer.init_params(jax.random.PRNGKey(0), cfg)
        tokens = np.random.default_rng(TOKEN_SEED).integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
        sparams = jax.tree.map(jax.device_put, params, sh.param_shardings(params, cfg, mesh))
        stok = jax.device_put(tokens, NamedSharding(mesh, sh.batch_specs(cfg, mesh, BATCH)["tokens"]))
        with mesh, activation_mesh(mesh):
            logits, caches = jax.jit(lambda p, t: steps.prefill(p, t, cfg, capacity_hint=SEQ + NEW))(
                sparams, stok)
            first_caches = jax.tree.map(np.asarray, caches)
            dec = jax.jit(lambda p, t, c, n: steps.decode_step(p, t, c, n, cfg))
            toks = [np.asarray(jnp.argmax(logits, -1))]
            for i in range(NEW):
                lg, caches = dec(sparams, jnp.asarray(toks[-1]), caches, jnp.int32(SEQ + i))
                toks.append(np.asarray(jnp.argmax(lg, -1)))
        def bits(a):  # bf16 travels as its uint16 bits
            a = np.asarray(a)
            return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

        arrays = {f"param/{k}": bits(v) for k, v in _flatten(params).items()}
        arrays.update({f"cache/{k}": bits(v) for k, v in _flatten(first_caches).items()})
        arrays["tokens"] = tokens
        arrays["logits"] = np.asarray(logits)
        arrays["greedy"] = np.stack(toks)
        np.savez(os.path.join(d, f"ref_{name}.npz"), **arrays)
        meta[name] = {"devices": jax.device_count()}
    with open(os.path.join(d, "ref.json"), "w") as f:
        json.dump(meta, f)


# --------------------------------------------------------------------------
# The port: eight gloo ranks.
# --------------------------------------------------------------------------

def _port_case(rank: int, d: str, name: str) -> dict:
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs, convert
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import activation_mesh, is_dtensor, placements
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import steps

    arch, quant = CASES[name]
    cfg = configs.reduced(arch, **_overrides(arch, quant))
    ref = dict(np.load(os.path.join(d, f"ref_{name}.npz")))
    tree = _unflatten({k[len("param/"):]: v for k, v in ref.items() if k.startswith("param/")})
    mesh = make_host_mesh(*MESH, device="cpu")
    params = convert.params_from_numpy(cfg, tree, "cpu", mesh=mesh)
    plain = convert.params_from_numpy(cfg, tree, "cpu")
    tokens = torch.from_numpy(ref["tokens"]).long()
    dtok = distribute_tensor(tokens, mesh, placements(sh.batch_specs(cfg, mesh, BATCH)["tokens"], mesh),
                             src_data_rank=None)

    def full(t):
        return t.full_tensor() if is_dtensor(t) else t

    def names(place):
        return [f"Shard({p.dim})" if p.is_shard() else "Replicate" for p in place]

    with activation_mesh(mesh):
        logits, caches = steps.prefill(params, dtok, cfg, capacity_hint=SEQ + NEW)
        got = {k: full(v) for k, v in _flatten(caches).items()}
        layout = {k: names(v.placements) for k, v in _flatten(caches).items()}
        toks = [full(logits).argmax(-1)]
        for i in range(NEW):
            lg, caches = steps.decode_step(params, toks[-1], caches, torch.tensor(SEQ + i), cfg)
            toks.append(full(lg).argmax(-1))
    # the reference's prefill caches placed on the mesh by the converter
    ref_caches = _unflatten({k[len("cache/"):]: v for k, v in ref.items() if k.startswith("cache/")})
    placed = [convert.cache_from_numpy(c, "cpu", cfg=cfg, mesh=mesh) for c in ref_caches]
    want_layout = {k: names(v.placements) for k, v in _flatten(placed).items()}
    spec_layout = {k: names(sh.NamedSharding(mesh, s).placements)
                   for k, s in _flatten(sh.cache_specs(ref_caches, cfg, mesh)).items()}
    # the port's unmeshed run
    l0, c0 = steps.prefill(plain, tokens, cfg, capacity_hint=SEQ + NEW)
    toks0 = [l0.argmax(-1)]
    for i in range(NEW):
        lg, c0 = steps.decode_step(plain, toks0[-1], c0, torch.tensor(SEQ + i), cfg)
        toks0.append(lg.argmax(-1))

    out: dict = {"layout": layout, "converter_layout": want_layout, "spec_layout": spec_layout}
    out["logits_max_abs"] = float((full(logits) - torch.from_numpy(ref["logits"])).abs().max())
    out["greedy"] = torch.stack(toks).tolist()
    out["greedy_unmeshed"] = torch.stack(toks0).tolist()
    out["cache_shapes"] = {k: list(v.shape) for k, v in got.items()}
    out["cache_dtypes"] = {k: str(v.dtype) for k, v in got.items()}
    diffs, positions, equal = {}, {}, {}
    for k, v in got.items():
        r = ref[f"cache/{k}"]
        r = (torch.from_numpy(r.view(np.int16)).view(torch.bfloat16) if r.dtype == np.uint16
             else torch.from_numpy(r))
        if tuple(r.shape) != tuple(v.shape):
            diffs[k] = float("inf")
            continue
        diffs[k] = float((v.double() - r.double()).abs().max())
        equal[k] = bool(torch.equal(v, r.to(v.dtype)))
        if k.split("/")[-1].startswith(("k", "v")):  # (P, B, L, ...): the slots written
            positions[k] = bool(torch.equal((v != 0).flatten(3).any(-1), (r != 0).flatten(3).any(-1)))
    out["cache_max_abs"], out["cache_equal"], out["positions_equal"] = diffs, equal, positions
    return out


def _rank(rank: int, world: int, d: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(d, "store"),
                            rank=rank, world_size=world)
    try:
        res = {name: _port_case(rank, d, name) for name in CASES}
        if rank == 0:
            with open(os.path.join(d, "port.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _port_main(d: str) -> None:
    import torch.multiprocessing as mp

    store = os.path.join(d, "store")
    if os.path.exists(store):  # a FileStore must start from no file
        os.remove(store)
    mp.spawn(_rank, args=(8, d), nprocs=8, join=True)


# --------------------------------------------------------------------------
# The tests.
# --------------------------------------------------------------------------

def _run(*args: str, timeout: int) -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                         capture_output=True, text=True, env=env, timeout=timeout)
    assert out.returncode == 0, f"{args[0]} failed:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve_mesh"))
    _run("ref", d, timeout=300)
    _run("port", d, timeout=300)
    with open(os.path.join(d, "ref.json")) as f:
        ref = json.load(f)
    with open(os.path.join(d, "port.json")) as f:
        port = json.load(f)
    greedy = {name: np.load(os.path.join(d, f"ref_{name}.npz"))["greedy"].tolist() for name in CASES}
    return ref, port, greedy


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_logits_match_reference_mesh(runs, name):
    ref, port, _ = runs
    assert ref[name]["devices"] == 8
    assert port[name]["logits_max_abs"] < LOGITS_TOL, port[name]["logits_max_abs"]


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_match_reference_mesh(runs, name):
    _, port, greedy = runs
    assert port[name]["greedy"] == greedy[name]


@pytest.mark.parametrize("name", [n for n in CASES if n != "dbrx"])
def test_greedy_tokens_match_unmeshed_port(runs, name):
    _, port, _ = runs
    assert port[name]["greedy"] == port[name]["greedy_unmeshed"]


@pytest.mark.parametrize("name", list(CASES))
def test_caches_placed_by_cache_specs(runs, name):
    _, port, _ = runs
    got = port[name]
    assert got["layout"] == got["spec_layout"] == got["converter_layout"]
    # batch over 'data'; levels on their slots, conv on channels, SSD on heads over 'model'
    model = {"conv": "Shard(3)"}
    for key, (data_p, model_p) in got["layout"].items():
        assert data_p == "Shard(1)", (key, data_p)
        assert model_p == model.get(key.split("/")[-1], "Shard(2)"), (key, model_p)


@pytest.mark.parametrize("name", list(CASES))
def test_cache_sizes_and_positions_bitwise(runs, name):
    _, port, _ = runs
    got = port[name]
    assert all(v != float("inf") for v in got["cache_max_abs"].values()), got["cache_shapes"]
    assert got["positions_equal"] or name == "mamba2"
    assert all(got["positions_equal"].values()), got["positions_equal"]


@pytest.mark.parametrize("name", list(CASES))
def test_stored_kv_within_logits_tolerance(runs, name):
    _, port, _ = runs
    got = port[name]
    codes = {k for k, dt in got["cache_dtypes"].items() if dt == "torch.int8"}
    bad = {k: v for k, v in got["cache_max_abs"].items() if not v < (1.5 if k in codes else LOGITS_TOL)}
    assert not bad, bad
    assert bool(codes) == CASES[name][1]


@pytest.mark.parametrize("nshards", [1, 2, 4])
@pytest.mark.parametrize("m", [1, 3])
def test_push_back_shard_form_writes_the_unsharded_levels(nshards, m):
    """K3's plain version in its shard form: the shards together write the
    unsharded levels, bitwise; positions and sizes are the whole wave's."""
    from repro_torch.kernels.push_back import ops, ref as pb_ref

    rng = np.random.default_rng(7 + nshards + m)
    b0, nlev, nblocks = 8, 3, 5
    sizes = torch.from_numpy(rng.integers(0, b0 * 7 - m, nblocks).astype(np.int32))
    elems = torch.from_numpy(rng.standard_normal((nblocks, m, 2, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random((nblocks, m)) < 0.7)
    whole = tuple(torch.zeros((nblocks, b0 << b, 2, 3)) for b in range(nlev))
    _, want_sizes, want_pos = pb_ref.push_back(whole, sizes, b0, elems, mask)
    parts = []
    for r in range(nshards):
        levels = tuple(torch.zeros((nblocks, (b0 << b) // nshards, 2, 3)) for b in range(nlev))
        _, new_sizes, pos = ops.push_back_fused_multi((levels,), sizes, b0, (elems,), mask, shard=r,
                                                      nshards=nshards)
        assert torch.equal(new_sizes, want_sizes) and torch.equal(pos, want_pos)
        parts.append(levels)
    for b in range(nlev):
        assert torch.equal(torch.cat([p[b] for p in parts], dim=1), whole[b])


def test_push_back_shard_form_per_level_counts():
    """A level that does not divide over the shards stays whole on every
    rank: per-level counts, the whole levels written as the unsharded ones."""
    from repro_torch.kernels.push_back import ref as pb_ref

    b0, nblocks = 2, 3
    sizes = torch.tensor([0, 5, 12], dtype=torch.int32)
    elems = torch.arange(nblocks * 4, dtype=torch.float32).reshape(nblocks, 4)
    mask = torch.ones((nblocks, 4), dtype=torch.bool)
    whole = tuple(torch.zeros((nblocks, b0 << b)) for b in range(4))
    pb_ref.push_back(whole, sizes, b0, elems, mask)
    counts = (1, 4, 4, 4)  # level 0 (2 slots) whole; the others split four ways
    parts = []
    for r in range(4):
        levels = tuple(torch.zeros((nblocks, (b0 << b) // n)) for b, n in enumerate(counts))
        pb_ref.push_back(levels, sizes, b0, elems, mask, shard=r, nshards=counts)
        parts.append(levels)
    assert all(torch.equal(p[0], whole[0]) for p in parts)
    for b in range(1, 4):
        assert torch.equal(torch.cat([p[b] for p in parts], dim=1), whole[b])


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        _ref_main(sys.argv[2])
    else:
        _port_main(sys.argv[2])
