"""The products that fold an activation's leading dims, on a device mesh:
eight gloo ranks of a (2, 4) ('data', 'model') mesh against the same
functions on plain tensors.

In the pattern of ``tests/test_torch_embed_mesh.py``: the file is its own
worker script.  ``python test_torch_mesh_products.py port DIR`` spawns
eight gloo ranks (a ``FileStore`` in DIR); rank 0 writes what they got to
``DIR/port.json``.  The pytest process initialises no process group.

Each case lays its input out as the model hands it over (the residual
stream: the batch over 'data', the sequence over 'model'; the attention's
output sequence-sharded; the logits vocab-sharded) and its weights by
``sharding.param_specs``, runs forward and backward under
``activation_mesh``, and compares the output and every gradient with the
unmeshed run's:
- bitwise, on exact data: small integers in f32 (inputs, weights and the
  output's cotangent), on which no sum rounds, so that a product whose
  contraction the mesh splits (``project_out``, the MLP's down projection)
  and sums over ranks gives the unmeshed bits as well.  Cases: the
  attention's q projection (heads over 'model') and k projection (kv
  heads that do not divide: head_dim over 'model'),
  ``project_out``, a ReLU MLP, the Mamba projections (``ssm._split_proj``),
  ``unembed``;
- bitwise, on standard-normal data: the outputs of the SSD scan in its
  ``local_map`` region (``ssm._ssd_region``: each rank runs the unmeshed
  scan on its own batch and heads) and of the triangular causal attention
  in its (``attention._tri_zigzag``: each rank runs the recursion for its
  own query rows);
- within ``RTOL`` = 1e-6 relative (max abs error over max abs value), on
  standard-normal data, where the mesh sums rounded partial results in
  another order: the SwiGLU MLP, the whole Mamba block (its gated norm and
  ``out_proj`` sum over the sharded inner dim), the vocab-parallel CE loss
  (``train.step._ce_loss``), the SSD scan's gradients (the ranks' shares
  of Bm's and Cm's over the heads, of A_log's, D's and dt_bias's over the
  batch) and the triangular attention's (k's and v's, summed over the
  query rows' ranks).  Measured: at most 5.3e-7.
- the reduced mamba2 train step on the mesh against the port's
  single-device step, as ``tests/test_torch_distributed.py`` holds qwen's:
  loss within 1e-5, each parameter within 1e-4 max abs;
- the same step from the reference's initial checkpoint against the
  reference's sharded step on eight host devices (``python
  test_torch_mesh_products.py ref DIR``, its own ``XLA_FLAGS``), as that
  file holds dbrx's: loss within ``REF_LOSS`` = 1e-4, each updated
  parameter within ``REF_PARAM`` = 1e-4 relative L2; and, since AdamW's
  first step moves a parameter by about lr whatever its gradient's
  scale, the gradients' global norm within ``REF_GNORM`` = 1e-5 relative
  (qwen's bound there).  Measured: loss equal, parameters within 2.3e-6,
  the norm within 3.4e-7.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

MESH = (2, 4)
BATCH, SEQ = 4, 16
SEED = 17
RTOL = 1e-6
STEP_LOSS, STEP_PARAM = 1e-5, 1e-4
REF_LOSS, REF_PARAM, REF_GNORM = 1e-4, 1e-4, 1e-5
LR = 1e-3


# --------------------------------------------------------------------------
# The reference: eight host devices.
# --------------------------------------------------------------------------

def _ref_main(d: str) -> None:
    """The reduced mamba2 train step, sharded by the reference's rules on
    its (2, 4) mesh: its initial parameters, its updated ones, the batch
    and the loss, under DIR."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax

    from repro import configs
    from repro.checkpoint import ckpt
    from repro.data.synthetic import make_batch
    from repro.distributed import sharding as sh
    from repro.distributed.context import activation_mesh
    from repro.optim import adamw
    from repro.train import step as train_mod

    assert jax.device_count() == 8, jax.device_count()
    mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = configs.reduced("mamba2-2.7b")
    state = train_mod.init_train_state(jax.random.PRNGKey(0), cfg)
    ckpt.save(os.path.join(d, "ref_init"), 0, state.params)
    batch = make_batch(cfg, BATCH, SEQ)
    params = jax.tree.map(jax.device_put, state.params, sh.param_shardings(state.params, cfg, mesh))
    sstate = train_mod.TrainState(params=params, opt=adamw.init(params), ef=None)
    with mesh, activation_mesh(mesh):
        out, metrics = jax.jit(lambda s, b: train_mod.train_step(
            s, b, cfg, adamw.AdamWConfig(lr=LR)))(sstate, batch)
    ckpt.save(os.path.join(d, "ref_step"), 1, out.params)
    np.save(os.path.join(d, "ref_tokens.npy"), np.asarray(batch["tokens"]))
    with open(os.path.join(d, "ref.json"), "w") as f:
        json.dump({"devices": jax.device_count(), "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"])}, f)
BITWISE = ["q", "k", "out", "mlp_relu", "ssm_proj", "unembed"]
CLOSE = ["mlp_swiglu", "mamba_block", "ce", "ssd", "tri"]


# --------------------------------------------------------------------------
# The port: eight gloo ranks.
# --------------------------------------------------------------------------

def _cases():
    """name → ((arch[, overrides]), build(rng, cfg) → (fn, x, x's logical
    axes, params, the params' key path in the model's tree, None for
    replicated ones, or a dict of each one's logical axes))."""
    import torch

    from repro_torch.distributed.context import as_dtensor, is_dtensor
    from repro_torch.models import attention, mlp, modules, ssm
    from repro_torch.train import step as tstep

    def exact(rng, shape, lo=-2, hi=2):
        return torch.from_numpy(rng.integers(lo, hi + 1, shape).astype(np.float32))

    def normal(rng, shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    resid = ("batch", "seq", None)

    def q(rng, cfg):
        p = {"wq": exact(rng, (cfg.d_model, cfg.n_heads, cfg.head_dim), -1, 1)}
        return (lambda x, p: attention.project_heads(x, p["wq"]), exact(rng, (BATCH, SEQ, cfg.d_model)),
                resid, p, ("attn",))

    def k(rng, cfg):
        p = {"wk": exact(rng, (cfg.d_model, cfg.n_kv_heads, cfg.head_dim), -1, 1)}
        return (lambda x, p: attention.project_heads(x, p["wk"]), exact(rng, (BATCH, SEQ, cfg.d_model)),
                resid, p, ("attn",))

    def out(rng, cfg):
        p = {"wo": exact(rng, (cfg.n_heads, cfg.head_dim, cfg.d_model), -1, 1)}
        return (lambda x, p: attention.project_out(p, x), exact(rng, (BATCH, SEQ, cfg.n_heads, cfg.head_dim)),
                ("batch", "seq", None, None), p, ("attn",))

    def mlp_case(activation, make):
        def build(rng, cfg):
            gen = torch.Generator().manual_seed(0)
            p = {name: make(rng, tuple(t.shape)) for name, t in
                 mlp.init_mlp(gen, cfg.d_model, cfg.d_ff, activation, torch.float32).items()}
            return (lambda x, p: mlp.mlp_block(p, x, activation), make(rng, (BATCH, SEQ, cfg.d_model)),
                    resid, p, ("mlp",))
        return build

    def mamba_params(rng, cfg, make):
        gen = torch.Generator().manual_seed(0)
        init = ssm.init_mamba(gen, cfg, torch.float32)
        p = {name: make(rng, tuple(t.shape)) * 0.1 for name, t in init.items()}
        p["A_log"], p["D"], p["dt_bias"] = init["A_log"], init["D"], init["dt_bias"]
        return p

    def ssm_proj(rng, cfg):
        gen = torch.Generator().manual_seed(0)
        names = ("wz", "wx", "wBC", "wdt")
        p = {n: exact(rng, tuple(t.shape), -1, 1) for n, t in ssm.init_mamba(gen, cfg, torch.float32).items()
             if n in names}
        return (lambda x, p: torch.cat(ssm._split_proj(p, x), dim=-1), exact(rng, (BATCH, SEQ, cfg.d_model)),
                resid, p, ("mamba",))

    def mamba_block(rng, cfg):
        return (lambda x, p: ssm.mamba_block(p, x, cfg), normal(rng, (BATCH, SEQ, cfg.d_model)), resid,
                mamba_params(rng, cfg, normal), ("mamba",))

    def ssd(rng, cfg):
        """The scan alone, on the conv's outputs (the sequence whole on
        every rank, as the block hands them over)."""
        s, di, nh, hd, g, n = ssm._dims(cfg)
        Q = min(s.chunk_size, SEQ)
        init = mamba_params(rng, cfg, normal)
        p = {"A_log": normal(rng, (nh,)), "D": init["D"], "dt_bias": init["dt_bias"]}
        xs = normal(rng, (BATCH, SEQ, di + 2 * g * n + nh))

        def fn(x, p):
            xs_, bm, cm, dt = torch.split(x, [di, g * n, g * n, nh], dim=-1)
            args = (xs_, bm, cm, dt, p["A_log"], p["D"], p["dt_bias"])
            core = lambda *a: ssm._ssd(*a, L=SEQ, Q=Q, g=g, hd=hd, out_dtype=x.dtype)  # noqa: E731
            return ssm._ssd_region(core, args, g) if is_dtensor(x) else core(*args)

        return fn, xs, ("batch", None, None), p, None

    def unembed(rng, cfg):
        p = {"embed": exact(rng, (cfg.padded_vocab, cfg.d_model), -1, 1)}
        return (lambda x, p: modules.unembed(x, p["embed"]), exact(rng, (BATCH, SEQ, cfg.d_model)), resid,
                p, ())

    def tri(rng, cfg):
        """The triangular causal attention (``--opt``'s) on q, k and v laid
        out as ``project_qkv`` leaves them: its zigzag region on the mesh."""
        kv = (BATCH, SEQ, cfg.n_kv_heads, cfg.head_dim)
        p = {"k": normal(rng, kv), "v": normal(rng, kv)}
        return (lambda x, p: attention.inner_attention(x, p["k"], p["v"], cfg, causal=True),
                normal(rng, (BATCH, SEQ, cfg.n_heads, cfg.head_dim)), ("batch", None, "heads", None), p,
                {"k": ("batch", None, "kv_heads", None), "v": ("batch", None, "kv_heads", None)})

    def ce(rng, cfg):
        targets = torch.from_numpy(rng.integers(0, cfg.padded_vocab, (BATCH, SEQ)))

        def fn(x, p):  # the targets a DTensor on a mesh, as the batch's tokens are
            return tstep._ce_loss(x, as_dtensor(targets, x.device_mesh) if is_dtensor(x) else targets)

        return (fn, normal(rng, (BATCH, SEQ, cfg.padded_vocab)),
                ("batch", None, "vocab"), {}, ())

    qwen, mamba = ("qwen2.5-3b",), ("mamba2-2.7b",)
    return {  # name → ((arch, overrides of its reduced config), build)
        "q": (qwen, q), "k": (("qwen2.5-3b", {"n_kv_heads": 2}), k), "out": (qwen, out),
        "mlp_relu": (qwen, mlp_case("relu", exact)), "mlp_swiglu": (qwen, mlp_case("swiglu", normal)),
        "ssm_proj": (mamba, ssm_proj), "ssd": (mamba, ssd), "mamba_block": (mamba, mamba_block),
        "unembed": (qwen, unembed), "ce": (qwen, ce),
        "tri": (("qwen2.5-3b", {"attention_impl": "blockwise_tri", "attention_chunk": 4}), tri),
    }


def _run_case(name: str, arch: tuple, build) -> dict:
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import activation_mesh, logical_spec, placements
    from repro_torch.launch.mesh import make_host_mesh

    cfg = configs.reduced(arch[0], **(arch[1] if len(arch) > 1 else {}))
    mesh = make_host_mesh(*MESH, device="cpu")
    rng = np.random.default_rng(SEED)
    fn, x, axes, p, where = build(rng, cfg)

    def nest(tree):
        for key in reversed(where or ()):
            tree = {key: tree}
        return tree

    def unnest(tree):
        for key in where or ():
            tree = tree[key]
        return tree

    if isinstance(where, dict):  # logical axes of each input
        specs = {k: logical_spec(tuple(v.shape), where[k], mesh) for k, v in p.items()}
    else:
        specs = unnest(sh.param_specs(nest(p), cfg, mesh)) if where is not None else {k: () for k in p}
    place = {k: placements(specs[k], mesh) for k in p}

    def run(x, p):
        x = x.clone().requires_grad_(True)
        p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y = fn(x, p)
        return (y if isinstance(y, tuple) else (y,)), x, p

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def loss(ys):
        return sum((y * c).sum() for y, c in zip(ys, cots))

    y0, x0, p0 = run(x, p)
    crng = np.random.default_rng(SEED + 1)
    cots = [torch.from_numpy(crng.integers(-2, 3, tuple(y.shape)).astype(np.float32)) for y in y0]
    loss(y0).backward()

    dx = distribute_tensor(x, mesh, placements(logical_spec(tuple(x.shape), axes, mesh), mesh), src_data_rank=None)
    dp = {k: distribute_tensor(v, mesh, place[k], src_data_rank=None) for k, v in p.items()}
    with activation_mesh(mesh):
        x1 = dx.detach().requires_grad_(True)
        p1 = {k: v.detach().requires_grad_(True) for k, v in dp.items()}
        y1 = fn(x1, p1)
        y1 = y1 if isinstance(y1, tuple) else (y1,)
        loss(y1).backward()
    pairs = [(f"out{i or ''}", full(a).detach(), b.detach()) for i, (a, b) in enumerate(zip(y1, y0))]
    pairs += [("grad_x", full(x1.grad), x0.grad)]
    pairs += [(f"grad_{k}", full(p1[k].grad), p0[k].grad) for k in p]

    def bits(t):
        return t.contiguous().view(torch.int32)

    res = {"x_placements": [repr(q) for q in dx.placements],
           "weight_sharded": any(q.is_shard() for v in place.values() for q in v)}
    for label, got, want in pairs:
        res[label] = {"bitwise": bool(torch.equal(bits(got), bits(want))),
                      "rel": float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))}
    return res


def _step_case() -> dict:
    """The reduced mamba2 train step on the mesh against the single-device step."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import activation_mesh, placements
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.tree import leaves, tree_map

    cfg = configs.reduced("mamba2-2.7b")
    mesh = make_host_mesh(*MESH, device="cpu")
    opt = adamw.AdamWConfig(lr=LR)
    single = tstep.init_train_state(0, cfg, device="cpu")
    batch = make_batch(cfg, BATCH, SEQ, device="cpu")
    single, sm = tstep.train_step(single, batch, cfg, opt)
    params = tstep.init_train_state(0, cfg, device="cpu").params
    params = tree_map(lambda t, s: distribute_tensor(t.detach(), mesh, s.placements, src_data_rank=None)
                      .requires_grad_(True), params, sh.param_shardings(params, cfg, mesh))
    state = tstep.TrainState(params=params, opt=adamw.init(params), ef=None)
    spec = sh.batch_specs(cfg, mesh, BATCH)["tokens"]
    b = {"tokens": distribute_tensor(batch["tokens"], mesh, placements(spec, mesh), src_data_rank=None)}
    with activation_mesh(mesh):
        state, m = tstep.train_step(state, b, cfg, opt, grad_specs=sh.param_specs(single.params, cfg, mesh))

    def full(t):
        return t.detach().full_tensor()

    return {"loss_diff": abs(float(full(m["loss"])) - float(sm["loss"])),
            "param_max_diff": max(float((full(a) - b.detach()).abs().max())
                                  for a, b in zip(leaves(state.params), leaves(single.params))),
            "finite": bool(torch.isfinite(full(m["loss"])))}


def _ref_step_case(d: str) -> dict:
    """The reduced mamba2 train step on the mesh from the reference's
    initial checkpoint, against the reference's sharded step."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import activation_mesh, placements
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.tree import leaves, paths

    cfg = configs.reduced("mamba2-2.7b")
    mesh = make_host_mesh(*MESH, device="cpu")
    like = tstep.init_train_state(0, cfg, device="cpu").params
    params, _ = ckpt.restore(os.path.join(d, "ref_init"), 0, like, shardings=sh.param_shardings(like, cfg, mesh))
    tokens = torch.from_numpy(np.load(os.path.join(d, "ref_tokens.npy")))
    spec = sh.batch_specs(cfg, mesh, BATCH)["tokens"]
    b = {"tokens": distribute_tensor(tokens, mesh, placements(spec, mesh), src_data_rank=None)}
    state = tstep.TrainState(params=params, opt=adamw.init(params), ef=None)
    with activation_mesh(mesh):
        state, m = tstep.train_step(state, b, cfg, adamw.AdamWConfig(lr=LR),
                                    grad_specs=sh.param_specs(like, cfg, mesh))
    want, _ = ckpt.restore(os.path.join(d, "ref_step"), 1, like)

    def full(t):
        return t.detach().full_tensor() if hasattr(t, "full_tensor") else t.detach()

    def rel(a, b):
        a, b = full(a).double(), b.detach().double()
        return float((a - b).norm() / max(float(b.norm()), 1e-30))

    return {"loss": float(full(m["loss"])), "grad_norm": float(full(m["grad_norm"])),
            "param_rel": {k: rel(a, w) for (k, a), w in zip(paths(state.params), leaves(want))}}


def _rank(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(d, "store"),
                            rank=rank, world_size=world)
    try:
        res = {name: _run_case(name, arch, build) for name, (arch, build) in _cases().items()}
        res["step"] = _step_case()
        res["ref_step"] = _ref_step_case(d)
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

@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_products"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC)
    env.pop("XLA_FLAGS", None)
    for mode in ("ref", "port"):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), mode, d],
                             capture_output=True, text=True, env=env, timeout=600)
        assert out.returncode == 0, f"{mode} failed:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}"
    with open(os.path.join(d, "port.json")) as f:
        got = json.load(f)
    with open(os.path.join(d, "ref.json")) as f:
        got["ref"] = json.load(f)
    return got


def _results(case: dict) -> dict:
    return {k: v for k, v in case.items() if isinstance(v, dict)}


@pytest.mark.parametrize("name", BITWISE)
def test_meshed_product_is_bitwise_unmeshed(port, name):
    got = _results(port[name])
    assert set(got) >= {"out", "grad_x"}
    bad = {k: v for k, v in got.items() if not v["bitwise"]}
    assert not bad, bad


@pytest.mark.parametrize("name", ["ssd", "tri"])
def test_region_output_is_bitwise_unmeshed(port, name):
    got = _results(port[name])
    outs = {k: v for k, v in got.items() if k.startswith("out")}
    assert outs and all(v["bitwise"] for v in outs.values()), got


@pytest.mark.parametrize("name", CLOSE)
def test_meshed_block_within_rtol_of_unmeshed(port, name):
    got = _results(port[name])
    bad = {k: v for k, v in got.items() if not v["rel"] <= RTOL}
    assert not bad, bad


@pytest.mark.parametrize("name", BITWISE + CLOSE)
def test_case_input_is_sharded_as_the_model_hands_it_over(port, name):
    """The cases meet the layouts the repair is for: the input sharded over
    both mesh dims (the sequence over 'model', but for the logits, whose
    vocab it is, and the SSD scan, which takes the whole sequence)."""
    got = port[name]
    assert got["x_placements"][0] == "Shard(dim=0)"
    want = {"ce": "Shard(dim=2)", "ssd": "Replicate()", "tri": "Shard(dim=2)"}.get(name, "Shard(dim=1)")
    assert got["x_placements"][1] == want
    assert got["weight_sharded"] or name in ("ce", "ssd", "tri")


def test_mamba2_step_on_the_mesh_matches_single_device(port):
    got = port["step"]
    assert got["finite"]
    assert got["loss_diff"] < STEP_LOSS, got
    assert got["param_max_diff"] < STEP_PARAM, got


def test_mamba2_step_on_the_mesh_matches_reference_mesh(port):
    ref, got = port["ref"], port["ref_step"]
    assert ref["devices"] == 8
    assert abs(got["loss"] - ref["loss"]) < REF_LOSS, (got["loss"], ref["loss"])
    assert abs(got["grad_norm"] / ref["grad_norm"] - 1) < REF_GNORM, (got["grad_norm"], ref["grad_norm"])
    bad = {k: v for k, v in got["param_rel"].items() if not v < REF_PARAM}
    assert not bad, bad


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        _ref_main(sys.argv[2])
    elif sys.argv[1] == "port":
        _port_main(sys.argv[2])
    else:
        raise SystemExit(f"usage: {sys.argv[0]} ref|port DIR")
