"""The port on a device mesh: eight gloo ranks on a (2, 4) ('data', 'model')
mesh against the reference's eight host devices on the same mesh.

Mirrors ``tests/distributed/test_multidevice.py`` and
``tests/train/test_loop_fault_tolerance.py::test_elastic_restore_onto_mesh_shardings``.
The file is its own worker script: ``python test_torch_distributed.py ref
DIR`` runs the reference with eight host devices (its own ``XLA_FLAGS``)
and writes its results under DIR; ``... port DIR N`` spawns N gloo ranks
of the port (a ``FileStore`` in DIR, no port number) that read them and
write their own.  The pytest process initialises no process group.

Tolerances:
- reduced dbrx, the port's sharded step against the reference's sharded
  step (both shard-local MoE capacity): loss within ``DBRX_LOSS`` = 1e-4,
  each updated parameter within ``DBRX_PARAM`` = 1e-4 relative L2, the
  tokens dropped on each shard equal;
- the same dbrx step in two microbatches under ``grad_specs`` (the f32
  accumulator a DTensor in the parameter layout) against the reference's
  two-microbatch step on its mesh: the same bounds;
- reduced qwen2.5-3b, sharded against the port's single-device step (both
  f32 on the CPU): loss within ``QWEN_LOSS`` = 1e-5, each parameter within
  ``QWEN_PARAM`` = 1e-4 max abs (a tenth of one step's lr), each leaf's
  update (after minus before) within ``QWEN_UPDATE`` = 1e-3 relative L2, the
  gradients' global norm within ``QWEN_GNORM`` = 1e-5 relative.  Measured:
  loss equal, 1.0e-5, 3.3e-5 and 6.9e-8.  The attention k bias has a true
  gradient of 0, so its update is rounding noise (1.9e-3 relative): it is
  held by the max abs bound alone.  The reference test's own bounds (loss
  2e-2, parameters 5e-2) were set for bf16 on a TPU; at lr 1e-3 a missing
  or wrong update stays inside them;
- the expert exchange, shard order, checkpoints and every one-rank mesh
  result: bitwise.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

DBRX_LOSS = 1e-4
DBRX_PARAM = 1e-4
QWEN_LOSS, QWEN_PARAM, QWEN_UPDATE, QWEN_GNORM = 1e-5, 1e-4, 1e-3, 1e-5
ZERO_GRAD = ("layers/0/attn/bk",)  # the k bias: softmax is invariant to it
MESH = (2, 4)
BATCH, SEQ = 4, 32
LR = 1e-3
A2A = (4, 3, 5)  # one rank's (E, C, D) block of the exchanged array
BLOCK_SEED = 5  # the MoE block's input


# --------------------------------------------------------------------------
# The reference: eight host devices.
# --------------------------------------------------------------------------

def _ref_main(d: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import configs
    from repro.checkpoint import ckpt
    from repro.data.synthetic import make_batch
    from repro.distributed import sharding as sh
    from repro.distributed.context import activation_mesh
    from repro.models import moe
    from repro.optim import adamw
    from repro.train import step as train_mod

    assert jax.device_count() == 8, jax.device_count()
    mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = configs.reduced("dbrx-132b")
    state = train_mod.init_train_state(jax.random.PRNGKey(0), cfg)
    ckpt.save(os.path.join(d, "ref_init"), 0, state.params)
    batch = make_batch(cfg, BATCH, SEQ)
    shardings = sh.param_shardings(state.params, cfg, mesh)
    sparams = jax.tree.map(jax.device_put, state.params, shardings)
    sstate = train_mod.TrainState(params=sparams, opt=adamw.init(sparams), ef=None)
    opt_cfg = adamw.AdamWConfig(lr=LR)
    with mesh, activation_mesh(mesh):
        out, metrics = jax.jit(lambda s, b: train_mod.train_step(s, b, cfg, opt_cfg))(sstate, batch)
        loss = float(metrics["loss"])
    ckpt.save(os.path.join(d, "ref_step"), 1, out.params)
    # the same step in two microbatches, grad_specs pinning the f32 accumulator
    gspecs = sh.param_specs(state.params, cfg, mesh)
    with mesh, activation_mesh(mesh):
        out2, metrics2 = jax.jit(lambda s, b: train_mod.train_step(
            s, b, cfg, opt_cfg, microbatches=2, grad_specs=gspecs))(sstate, batch)
        loss_mb2 = float(metrics2["loss"])
    ckpt.save(os.path.join(d, "ref_step_mb2"), 1, out2.params)

    # layer 0's MoE block on a seeded input, and each shard's drops: the
    # shard-local routing the reference's local_block runs
    p0 = jax.tree.map(lambda a: a[0], state.params["layers"][0]["moe"])
    x = np.random.default_rng(BLOCK_SEED).standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
    with mesh, activation_mesh(mesh):
        y, aux = jax.jit(lambda p, x: moe.moe_block(p, x, cfg))(p0, x)
    dp, tp = MESH
    b, s = BATCH // dp, SEQ // tp
    C_local = moe.expert_capacity(cfg.moe, b * s)
    drops = []
    for i in range(dp):
        for j in range(tp):
            xs = jnp.asarray(x[i * b:(i + 1) * b, j * s:(j + 1) * s].reshape(b * s, -1))
            _, slot, _, _ = moe._route_and_pack(p0, xs, cfg, C_local)
            drops.append(int(jnp.sum(slot < 0)))

    # the tiled all_to_all there and back, and where P(("data", "model")) puts each block
    E = A2A[0]
    G = np.random.default_rng(11).standard_normal((8 * E, *A2A[1:])).astype(np.float32)
    spec = P(("data", "model"))

    def exch(split, concat):
        return jax.shard_map(lambda a: jax.lax.all_to_all(a, "model", split, concat, tiled=True),
                             mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)

    there = exch(0, 1)(G)
    back = exch(1, 0)(there)
    placed = jax.device_put(G, NamedSharding(mesh, spec))
    devs = np.asarray(mesh.devices)
    starts = [0] * 8
    for shard in placed.addressable_shards:
        i, j = (int(v) for v in np.argwhere(devs == shard.device)[0])
        starts[i * tp + j] = int(shard.index[0].start)
    np.savez(os.path.join(d, "ref.npz"), tokens=np.asarray(batch["tokens"]), x=x, y=np.asarray(y),
             G=G, there=np.asarray(there), back=np.asarray(back))
    with open(os.path.join(d, "ref.json"), "w") as f:
        json.dump({"devices": jax.device_count(), "loss": loss, "loss_mb2": loss_mb2, "aux": float(aux),
                   "drops": drops, "C_local": C_local, "starts": starts}, f)


# --------------------------------------------------------------------------
# The port: N gloo ranks.
# --------------------------------------------------------------------------

def _full(t):
    from repro_torch.distributed.context import is_dtensor

    t = t.detach()
    return t.full_tensor() if is_dtensor(t) else t


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _distribute(tree, cfg, mesh):
    """Plain parameters → DTensors in the rule layout, requiring grad."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding as sh
    from repro_torch.tree import tree_map

    return tree_map(lambda p, s: distribute_tensor(p.detach(), mesh, s.placements,
                                                   src_data_rank=None).requires_grad_(True),
                    tree, sh.param_shardings(tree, cfg, mesh))


def _port_eight(rank: int, d: str) -> dict:
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import activation_mesh, placements
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.tree import leaves, paths

    out: dict = {}
    ref = dict(np.load(os.path.join(d, "ref.npz")))
    mesh = make_host_mesh(*MESH, device="cpu")
    opt = adamw.AdamWConfig(lr=LR)

    # dbrx: the reference's initial checkpoint restored onto the mesh, one step
    cfg = dataclasses.replace(configs.reduced("dbrx-132b"), insertion_method="tile")
    like = tstep.init_train_state(0, cfg, device="cpu").params
    params, _ = ckpt.restore(os.path.join(d, "ref_init"), 0, like,
                             shardings=sh.param_shardings(like, cfg, mesh))
    plain, _ = ckpt.restore(os.path.join(d, "ref_init"), 0, like)
    out["ref_restore_mismatches"] = sum(not torch.equal(_full(a), b)
                                        for a, b in zip(leaves(params), leaves(plain)))
    out["ref_restore_placements"] = [str(list(p.placements)) for p in leaves(params)]
    tokens = torch.from_numpy(ref["tokens"])
    bspec = sh.batch_specs(cfg, mesh, BATCH)["tokens"]
    batch = {"tokens": distribute_tensor(tokens, mesh, placements(bspec, mesh), src_data_rank=None)}
    state = tstep.TrainState(params=params, opt=adamw.init(params), ef=None)
    with activation_mesh(mesh):
        state, m = tstep.train_step(state, batch, cfg, opt, grad_specs=sh.param_specs(like, cfg, mesh))
    out["dbrx_loss"] = float(_full(m["loss"]))
    want, _ = ckpt.restore(os.path.join(d, "ref_step"), 1, like)
    out["dbrx_param_rel"] = {k: _rel(_full(a), b) for (k, a), b in zip(paths(state.params), leaves(want))}
    # the same step in two microbatches: the DTensor accumulator under grad_specs
    params, _ = ckpt.restore(os.path.join(d, "ref_init"), 0, like,
                             shardings=sh.param_shardings(like, cfg, mesh))
    state = tstep.TrainState(params=params, opt=adamw.init(params), ef=None)
    with activation_mesh(mesh):
        state, m = tstep.train_step(state, batch, cfg, opt, microbatches=2,
                                    grad_specs=sh.param_specs(like, cfg, mesh))
    out["dbrx_mb2_loss"] = float(_full(m["loss"]))
    want, _ = ckpt.restore(os.path.join(d, "ref_step_mb2"), 1, like)
    out["dbrx_mb2_param_rel"] = {k: _rel(_full(a), b) for (k, a), b in zip(paths(state.params), leaves(want))}
    out["dbrx_mb2_param_layout"] = all(list(a.placements) == list(s.placements) for a, s in zip(
        leaves(state.params), leaves(sh.param_shardings(like, cfg, mesh))))

    # layer 0's MoE block: the drops on each shard, the output against the reference's
    p0 = {k: v[0].detach() for k, v in plain["layers"][0]["moe"].items()}
    rep = [torch.distributed.tensor.Replicate()] * 2
    pd = {k: distribute_tensor(v, mesh, rep) for k, v in p0.items()}
    xd = distribute_tensor(torch.from_numpy(ref["x"]), mesh, rep)
    seen = []
    route = moe._route_and_pack

    def spy(p, xt, cfg_, C):
        got = route(p, xt, cfg_, C)
        seen.append((int((got[1] < 0).sum()), C))
        return got

    moe._route_and_pack = spy
    try:
        with activation_mesh(mesh):
            y, aux = moe.moe_block(pd, xd, dataclasses.replace(cfg, insertion_method="mxu"))
    finally:
        moe._route_and_pack = route
    drops = [None] * dist.get_world_size()
    dist.all_gather_object(drops, seen)
    out["drops"] = drops
    out["block_max_abs"] = float((_full(y) - torch.from_numpy(ref["y"])).abs().max())
    out["block_aux"] = float(_full(aux))

    # the exchange there and back against jax.lax.all_to_all(tiled=True)
    E = A2A[0]
    G = torch.from_numpy(ref["G"])
    group = mesh.get_group("model")
    there = moe._exchange(G[rank * E:(rank + 1) * E], group, MESH[1], True)
    back = moe._exchange(torch.from_numpy(ref["there"])[rank * (E // MESH[1]):(rank + 1) * (E // MESH[1])],
                         group, MESH[1], False)
    ok = [torch.equal(there, torch.from_numpy(ref["there"])[rank * (E // MESH[1]):(rank + 1) * (E // MESH[1])]),
          torch.equal(back, torch.from_numpy(ref["back"])[rank * E:(rank + 1) * E])]
    # a tuple of axes: 'data' major, as JAX places it
    local = distribute_tensor(G, mesh, placements((("data", "model"), None, None), mesh)).to_local()
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, (ok, int(next(s for s in range(0, 8 * E, E)
                                                  if torch.equal(G[s:s + E], local)))))
    out["exchange"] = flags

    # qwen2.5-3b: sharded against the port's own single-device step
    qcfg = configs.reduced("qwen2.5-3b")
    single = tstep.init_train_state(0, qcfg, device="cpu")
    qbatch = make_batch(qcfg, BATCH, SEQ, device="cpu")
    init = [p.detach().clone() for p in leaves(single.params)]
    single, sm = tstep.train_step(single, qbatch, qcfg, opt)
    qparams = _distribute(tstep.init_train_state(0, qcfg, device="cpu").params, qcfg, mesh)
    qstate = tstep.TrainState(params=qparams, opt=adamw.init(qparams), ef=None)
    qspec = sh.batch_specs(qcfg, mesh, BATCH)["tokens"]
    qb = {"tokens": distribute_tensor(qbatch["tokens"], mesh, placements(qspec, mesh), src_data_rank=None)}
    with activation_mesh(mesh):
        qstate, qm = tstep.train_step(qstate, qb, qcfg, opt, grad_specs=sh.param_specs(single.params, qcfg, mesh))
    out["qwen_loss_diff"] = abs(float(_full(qm["loss"])) - float(sm["loss"]))
    out["qwen_param_max_diff"] = max(float((_full(a) - b.detach()).abs().max())
                                     for a, b in zip(leaves(qstate.params), leaves(single.params)))
    # what the step changed: each leaf's update, and the gradients' global norm
    out["qwen_update_rel"] = {k: _rel(_full(a) - p0, b.detach() - p0) for (k, a), b, p0
                              in zip(paths(qstate.params), leaves(single.params), init)}
    out["qwen_grad_norm_rel"] = abs(float(_full(qm["grad_norm"])) / float(sm["grad_norm"]) - 1)

    # elastic: saved under (2, 4), restored onto (4, 2); (1, 1) in the one-rank run
    saved = _distribute(tstep.init_train_state(3, qcfg, device="cpu").params, qcfg, mesh)
    ckpt.save(os.path.join(d, "elastic"), 1, saved)
    mesh_b = make_host_mesh(4, 2, device="cpu")
    back, _ = ckpt.restore(os.path.join(d, "elastic"), 1, single.params,
                           shardings=sh.param_shardings(single.params, qcfg, mesh_b))
    out["elastic_42_mismatches"] = sum(not torch.equal(_full(a), _full(b))
                                       for a, b in zip(leaves(back), leaves(saved)))
    out["elastic_42_mesh"] = list(leaves(back)[0].device_mesh.shape)
    return out


def _port_one(rank: int, d: str) -> dict:
    """One rank: a (1, 1) mesh on the CPU, as one card runs it."""
    import dataclasses

    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.tree import leaves

    out: dict = {}
    mesh = make_host_mesh(1, 1, device="cpu")
    qcfg = configs.reduced("qwen2.5-3b")
    like = tstep.init_train_state(3, qcfg, device="cpu").params
    back, _ = ckpt.restore(os.path.join(d, "elastic"), 1, like,
                           shardings=sh.param_shardings(like, qcfg, mesh))
    out["elastic_11_mismatches"] = sum(not torch.equal(_full(a), b.detach())
                                       for a, b in zip(leaves(back), leaves(like)))
    # the reference test: a host-saved checkpoint under (1, 1) shardings
    ckpt.save(os.path.join(d, "host"), 1, like)
    back, _ = ckpt.restore(os.path.join(d, "host"), 1, like,
                           shardings=sh.param_shardings(like, qcfg, mesh))
    out["host_11_mismatches"] = sum(not torch.equal(_full(a), b.detach())
                                    for a, b in zip(leaves(back), leaves(like)))
    out["host_11_dtensor"] = all(type(a).__name__ == "DTensor" for a in leaves(back))

    # dbrx on the one-rank mesh: plain tensors and DTensors take _moe_sharded,
    # bitwise the unmeshed block and step; under remat the recompute does too
    cfg = dataclasses.replace(configs.reduced("dbrx-132b"), insertion_method="mxu", remat=True)
    calls = []
    sharded = moe._moe_sharded

    def count(*a):
        calls.append(1)
        return sharded(*a)

    moe._moe_sharded = count
    try:
        plain = tstep.init_train_state(1, cfg, device="cpu")
        p0 = {k: v[0].detach() for k, v in plain.params["layers"][0]["moe"].items()}
        x = torch.from_numpy(np.random.default_rng(BLOCK_SEED).standard_normal(
            (BATCH, SEQ, cfg.d_model)).astype(np.float32))
        y0, a0 = moe.moe_block(p0, x, cfg)
        with activation_mesh(mesh):
            y1, a1 = moe.moe_block(p0, x, cfg)
        out["one_rank_block_bitwise"] = bool(torch.equal(y0, y1) and torch.equal(a0, a1))
        batch = make_batch(cfg, BATCH, SEQ, device="cpu")
        opt = adamw.AdamWConfig(lr=LR)
        meshed = _distribute(tstep.init_train_state(1, cfg, device="cpu").params, cfg, mesh)
        mstate = tstep.TrainState(params=meshed, opt=adamw.init(meshed), ef=None)
        before = len(calls)
        plain, pm = tstep.train_step(plain, batch, cfg, opt)
        out["unmeshed_sharded_calls"] = len(calls) - before
        with activation_mesh(mesh):
            db = {"tokens": distribute_tensor(batch["tokens"], mesh, [torch.distributed.tensor.Replicate()] * 2)}
            mstate, mm = tstep.train_step(mstate, db, cfg, opt, grad_specs=sh.param_specs(meshed, cfg, mesh))
        out["sharded_calls"] = len(calls)
        out["one_rank_loss_bitwise"] = float(_full(mm["loss"])) == float(pm["loss"])
        out["one_rank_param_mismatches"] = sum(not torch.equal(_full(a), b.detach())
                                               for a, b in zip(leaves(mstate.params), leaves(plain.params)))
    finally:
        moe._moe_sharded = sharded
    return out


def _rank(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(d, f"store{world}"),
                           rank=rank, world_size=world)
    try:
        res = (_port_eight if world == 8 else _port_one)(rank, d)
        if rank == 0:
            with open(os.path.join(d, f"port{world}.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _port_main(d: str, world: int) -> None:
    import torch.multiprocessing as mp

    store = os.path.join(d, f"store{world}")
    if os.path.exists(store):  # a FileStore must start from no file
        os.remove(store)
    mp.spawn(_rank, args=(world, d), nprocs=world, join=True)


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
    d = str(tmp_path_factory.mktemp("mesh"))
    _run("ref", d, timeout=300)
    _run("port", d, "8", timeout=300)
    _run("port", d, "1", timeout=200)
    got = {}
    for name in ("ref", "port8", "port1"):
        with open(os.path.join(d, f"{name}.json")) as f:
            got[name] = json.load(f)
    return got


def test_dbrx_sharded_step_matches_reference_mesh(runs):
    ref, port = runs["ref"], runs["port8"]
    assert ref["devices"] == 8
    assert abs(port["dbrx_loss"] - ref["loss"]) < DBRX_LOSS, (port["dbrx_loss"], ref["loss"])
    bad = {k: v for k, v in port["dbrx_param_rel"].items() if not v < DBRX_PARAM}
    assert not bad, bad


def test_dbrx_two_microbatch_step_matches_reference_mesh(runs):
    ref, port = runs["ref"], runs["port8"]
    assert abs(port["dbrx_mb2_loss"] - ref["loss_mb2"]) < DBRX_LOSS, (port["dbrx_mb2_loss"], ref["loss_mb2"])
    bad = {k: v for k, v in port["dbrx_mb2_param_rel"].items() if not v < DBRX_PARAM}
    assert not bad, bad
    assert port["dbrx_mb2_param_layout"]


def test_dbrx_drops_the_reference_tokens_on_each_shard(runs):
    ref, port = runs["ref"], runs["port8"]
    # one _route_and_pack call a rank, at the shard-local capacity
    assert [r[0][1] for r in port["drops"]] == [ref["C_local"]] * 8
    assert [r[0][0] for r in port["drops"]] == ref["drops"]
    assert sum(ref["drops"]) > 0  # the check sees drops
    assert port["block_max_abs"] < 1e-5 and abs(port["block_aux"] - ref["aux"]) < 1e-6


def test_qwen_sharded_step_matches_single_device(runs):
    port = runs["port8"]
    assert port["qwen_loss_diff"] < QWEN_LOSS, port
    assert port["qwen_param_max_diff"] < QWEN_PARAM, port
    bad = {k: v for k, v in port["qwen_update_rel"].items() if k not in ZERO_GRAD and not v < QWEN_UPDATE}
    assert not bad, bad
    assert port["qwen_grad_norm_rel"] < QWEN_GNORM, port


def test_exchange_is_bitwise_jax_all_to_all(runs):
    assert all(all(ok) for ok, _ in runs["port8"]["exchange"])


def test_tuple_of_axes_shards_first_axis_major(runs):
    assert [start for _, start in runs["port8"]["exchange"]] == runs["ref"]["starts"]
    assert runs["ref"]["starts"] == [r * A2A[0] for r in range(8)]


def test_elastic_reshard_across_mesh_shapes(runs):
    assert runs["port8"]["elastic_42_mismatches"] == 0
    assert runs["port8"]["elastic_42_mesh"] == [4, 2]
    assert runs["port1"]["elastic_11_mismatches"] == 0


def test_reference_checkpoint_restores_with_shardings(runs):
    port = runs["port8"]
    assert port["ref_restore_mismatches"] == 0
    assert any("Shard" in p for p in port["ref_restore_placements"])


def test_elastic_restore_onto_mesh_shardings(runs):
    assert runs["port1"]["host_11_mismatches"] == 0 and runs["port1"]["host_11_dtensor"]


def test_one_rank_mesh_takes_moe_sharded_bitwise(runs):
    one = runs["port1"]
    # the block once, then each of the 2 periods forward and in the remat recompute
    assert one["unmeshed_sharded_calls"] == 0 and one["sharded_calls"] == 1 + 2 * 2
    assert one["one_rank_block_bitwise"]
    assert one["one_rank_loss_bitwise"] and one["one_rank_param_mismatches"] == 0


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        _ref_main(sys.argv[2])
    else:
        _port_main(sys.argv[2], int(sys.argv[3]))
