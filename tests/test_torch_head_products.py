"""A head-dim-sharded projection on a device mesh is one product: eight
gloo ranks of a (2, 4) ('data', 'model') mesh.

Where a config's heads do not divide over 'model' (dbrx's and qwen2.5-3b's
KV heads at full size), ``sharding.param_specs`` shards the weights'
head_dim instead, and ``attention.project_heads`` / ``project_out`` run
one product over the (head_dim, heads)-ordered view of the weight
(``attention._split_head_dim``).  The yardstick, kept here, is the form
they replaced: one product a head (``_loop_heads``, ``_loop_out``).

In the pattern of ``tests/test_torch_mesh_products.py``: the file is its
own worker script.  ``python test_torch_head_products.py port DIR``
spawns eight gloo ranks (a ``FileStore`` in DIR); rank 0 writes what they
got to ``DIR/port.json``.  The pytest process initialises no process
group.  Each case runs forward and backward on exact data (small integers
in f32, on which no sum rounds) through the port's function and through
the yardstick, both on the mesh, and through the port's function on plain
tensors, under a dispatch mode that counts the products (``aten.mm``,
``addmm``, ``bmm``) the forward issues on ``DTensor``s.  Held: one
product, the output and every gradient bitwise the yardstick's and the
unmeshed run's.
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
SEED = 23
# reduced qwen2.5-3b with two heads and two KV heads: neither divides over
# 'model' = 4, so every projection's head_dim is sharded
ARCH = ("qwen2.5-3b", {"n_heads": 2, "n_kv_heads": 2})
PRODUCTS = ("aten.mm.default", "aten.addmm.default", "aten.bmm.default")


def _loop_heads(x, w):
    """The yardstick: one product a head."""
    import torch

    return torch.stack([x @ w[:, j] for j in range(w.shape[1])], dim=-2)


def _loop_out(attn_out, wo):
    out = attn_out[..., 0, :] @ wo[0]
    for j in range(1, wo.shape[0]):
        out = out + attn_out[..., j, :] @ wo[j]
    return out


def _cases():
    """name → (the port's function, the yardstick, x's shape, x's logical
    axes, the weight's name and shape)."""
    from repro_torch.distributed.context import merge_ready
    from repro_torch.models import attention

    def heads(x, w):
        return attention.project_heads(x, w)

    def out(x, w):
        return attention.project_out({"wo": w}, x)

    resid = ("batch", "seq", None)

    def specs(cfg):
        d, h, kh, k = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        return {
            "q": (heads, lambda x, w: _loop_heads(merge_ready(x), w), (BATCH, SEQ, d), resid, "wq", (d, h, k)),
            "k": (heads, lambda x, w: _loop_heads(merge_ready(x), w), (BATCH, SEQ, d), resid, "wk", (d, kh, k)),
            "out": (out, lambda x, w: _loop_out(merge_ready(x, 0, x.ndim - 2), w), (BATCH, SEQ, h, k),
                    ("batch", None, "heads", None), "wo", (h, k, d)),
        }

    return specs


def _run_case(cfg, fn, loop, xshape, axes, wname, wshape) -> dict:
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import activation_mesh, logical_spec, placements
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(*MESH, device="cpu")
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.integers(-2, 3, xshape).astype(np.float32))
    w = torch.from_numpy(rng.integers(-1, 2, wshape).astype(np.float32))
    spec = sh.param_specs({"attn": {wname: w}}, cfg, mesh)["attn"][wname]

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if str(func) in PRODUCTS and any(issubclass(t, DTensor) for t in types):
                self.n += 1
            return func(*args, **(kwargs or {}))

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    yshape = (*xshape[:-1], *wshape[1:]) if wname != "wo" else (*xshape[:-2], wshape[-1])
    cot = torch.from_numpy(np.random.default_rng(SEED + 1).integers(-2, 3, yshape).astype(np.float32))
    res = {"w_placements": [repr(q) for q in placements(spec, mesh)]}
    runs = {}
    for label, f, meshed in (("plain", fn, False), ("port", fn, True), ("loop", loop, True)):
        xi, wi = x.clone(), w.clone()
        if meshed:
            xi = distribute_tensor(xi, mesh, placements(logical_spec(xshape, axes, mesh), mesh),
                                   src_data_rank=None)
            wi = distribute_tensor(wi, mesh, placements(spec, mesh), src_data_rank=None)
        xi, wi = xi.detach().requires_grad_(True), wi.detach().requires_grad_(True)
        count = Products()
        with activation_mesh(mesh if meshed else None):
            with count:
                y = f(xi, wi)
            (full(y) * cot).sum().backward()
        runs[label] = {"y": full(y).detach(), "grad_x": full(xi.grad), "grad_w": full(wi.grad),
                       "products": count.n}

    def bits(t):
        return t.contiguous().view(torch.int32)

    for label in ("port", "loop"):
        res[f"{label}_products"] = runs[label]["products"]
    for key in ("y", "grad_x", "grad_w"):
        got = runs["port"][key]
        res[key] = {"loop": bool(torch.equal(bits(got), bits(runs["loop"][key]))),
                    "plain": bool(torch.equal(bits(got), bits(runs["plain"][key])))}
    return res


def _rank(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import configs

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(d, "store"),
                            rank=rank, world_size=world)
    try:
        cfg = configs.reduced(ARCH[0], **ARCH[1])
        res = {name: _run_case(cfg, *case) for name, case in _cases()(cfg).items()}
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
    d = str(tmp_path_factory.mktemp("head_products"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "port", d],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, f"port failed:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}"
    with open(os.path.join(d, "port.json")) as f:
        return json.load(f)


CASES = ["q", "k", "out"]


@pytest.mark.parametrize("name", CASES)
def test_head_dim_sharded_projection_is_one_product(port, name):
    got = port[name]
    # the case meets the layout the change is for: the head_dim over 'model'
    assert got["w_placements"][1] == ("Shard(dim=1)" if name == "out" else "Shard(dim=2)"), got
    assert got["port_products"] == 1, got
    assert got["loop_products"] == 2, got  # the yardstick: one a head


@pytest.mark.parametrize("name", CASES)
def test_head_dim_sharded_projection_bitwise_the_per_head_loop(port, name):
    got = port[name]
    bad = {k: v for k, v in got.items() if isinstance(v, dict) and not (v["loop"] and v["plain"])}
    assert not bad, bad


if __name__ == "__main__":
    if sys.argv[1] == "port":
        _port_main(sys.argv[2])
    else:
        raise SystemExit(f"usage: {sys.argv[0]} port DIR")
