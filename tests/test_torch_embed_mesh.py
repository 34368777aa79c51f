"""The embedding lookup on a device mesh: ``models.modules.embed`` on a
vocab-sharded ``DTensor`` table, on eight gloo ranks of a (2, 4) ('data',
'model') mesh, against the unmeshed lookup ``table[tokens]``.

In the pattern of ``tests/test_torch_sharded_serving.py``: the file is its
own worker script.  ``python test_torch_embed_mesh.py port DIR`` spawns
eight gloo ranks (a ``FileStore`` in DIR); rank 0 writes what they got to
``DIR/port.json``.  The pytest process initialises no process group.

Cases: the tables of reduced qwen2.5-3b (tied embeddings) and dbrx, laid
out by ``sharding.param_specs`` (vocab over 'model', embed over 'data'),
at the padded vocab (256, which divides over 'model') and at 254 rows
(which does not: ``shard_if_divisible`` keeps the vocab whole on every
rank); and a 254-row table split unevenly over 'model' by hand (64, 64,
63, 63 rows), which no rule makes but the lookup must survive.  Tokens
(prefill-shaped and decode-shaped) are laid out by ``batch_specs`` and
include the first and the last row.

What holds:
- the meshed lookup and its table gradient are bitwise the unmeshed ones
  (f32 on the CPU), and the meshed lookup is bitwise the reference's
  ``repro.models.modules.embed`` (``jnp.take``) on the same numpy table
  and tokens, run in the pytest process.  The random tables hold no -0.0 (asserted), the one
  value a vocab-split lookup changes: a row planted as -0.0 comes back
  +0.0 where the vocab is split over ranks (its row plus the other
  slices' zeros) and -0.0 where it is not;
- the lookup never hands the ``DTensor`` table to ``aten.index`` or
  ``aten.embedding`` (DTensor's rule for ``aten.index.Tensor`` replicates
  a vocab-sharded table under torch 2.11; 2.13 shards it, so under 2.13
  the bytes alone would not show the fault), and no collective in
  ``analysis.flops.count_fn``'s record moves as many bytes as the table;
- the result shards the embed dim over every mesh dim that shards the
  table, and carries no pending sum.
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
SEED = 11
NEG_ZERO_ROW = 5
# name → (arch, table rows or None for the config's padded vocab, split the rows by hand)
CASES = {
    "qwen": ("qwen2.5-3b", None, False),
    "qwen_fallback": ("qwen2.5-3b", 254, False),
    "dbrx": ("dbrx-132b", None, False),
    "dbrx_fallback": ("dbrx-132b", 254, False),
    "uneven": ("qwen2.5-3b", 254, True),
}
SHAPES = {"prefill": (BATCH, SEQ), "decode": (BATCH, 1)}


# --------------------------------------------------------------------------
# The port: eight gloo ranks.
# --------------------------------------------------------------------------

def _placed_table(cfg, mesh, rows: int, uneven: bool):
    """(the table as a plain tensor, its spec's placements on ``mesh``)."""
    import torch

    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import PartitionSpec, placements

    table = torch.from_numpy(np.random.default_rng(SEED).standard_normal((rows, cfg.d_model),
                                                                        dtype=np.float32))
    embed = sh.logical_rules(cfg, mesh)["embed"]
    if uneven:
        spec = PartitionSpec("model", embed)
    elif rows == cfg.padded_vocab:
        spec = sh.param_specs({"embed": table}, cfg, mesh)["embed"]
    else:
        spec = PartitionSpec(sh.shard_if_divisible(mesh, rows, "model"), embed)
    return table, placements(spec, mesh)


def _port_case(d: str, name: str) -> dict:
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import configs
    from repro_torch.analysis import flops
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import activation_mesh, placements
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.modules import embed

    arch, rows, uneven = CASES[name]
    cfg = configs.reduced(arch)
    rows = cfg.padded_vocab if rows is None else rows
    mesh = make_host_mesh(*MESH, device="cpu")
    table, place = _placed_table(cfg, mesh, rows, uneven)
    dtable = distribute_tensor(table, mesh, place, src_data_rank=None)
    rng = np.random.default_rng(SEED + 1)

    class Record(TorchDispatchMode):
        """The aten ops that receive the ``DTensor`` table itself."""

        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(a is dtable for a in args):
                self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    def bits(t):
        return t.contiguous().view(torch.int32)

    out: dict = {"rows": rows, "d_model": cfg.d_model,
                 "table_bytes": table.numel() * table.element_size(),
                 "table_negative_zeros": int(((table == 0) & torch.signbit(table)).sum()),
                 "table_placements": [repr(p) for p in place]}
    for shape_name, shape in SHAPES.items():
        tokens = torch.from_numpy(rng.integers(0, rows, shape)).long()
        tokens[0, 0], tokens[-1, -1], tokens[1, 0] = 0, rows - 1, NEG_ZERO_ROW
        dtok = distribute_tensor(tokens, mesh, placements(sh.batch_specs(cfg, mesh, BATCH)["tokens"], mesh),
                                 src_data_rank=None)
        want = table[tokens]
        r: dict = {}
        with activation_mesh(mesh):
            rec = Record()
            with rec:
                got = embed(dtable, dtok)
            r["placements"] = [repr(p) for p in got.placements]
            full = got.full_tensor()
            r["bitwise"] = bool(torch.equal(bits(full), bits(want)))
            if torch.distributed.get_rank() == 0:  # for the reference, in the pytest process
                np.save(os.path.join(d, f"{name}_{shape_name}_tokens.npy"), tokens.numpy())
                np.save(os.path.join(d, f"{name}_{shape_name}_got.npy"), full.numpy())
            r["plain_tokens_bitwise"] = bool(torch.equal(bits(embed(dtable, tokens).full_tensor()), bits(want)))
            r["table_ops"] = rec.ops
            r["collectives"] = flops.count_fn(embed, dtable, dtok)["collectives"]
            # the table's gradient through a weighted sum of the rows
            w = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
                (*shape, cfg.d_model), dtype=np.float32))
            leaf = distribute_tensor(table, mesh, place, src_data_rank=None).requires_grad_()
            (embed(leaf, dtok) * w).sum().backward()
            plain = table.clone().requires_grad_()
            (plain[tokens] * w).sum().backward()
            r["grad_bitwise"] = bool(torch.equal(bits(leaf.grad.full_tensor()), bits(plain.grad)))
            r["grad_placements"] = [repr(p) for p in leaf.grad.placements]
            # a row stored as -0.0
            signed = table.clone()
            signed[NEG_ZERO_ROW] = -0.0
            got0 = embed(distribute_tensor(signed, mesh, place, src_data_rank=None), dtok).full_tensor()
            r["neg_zero_kept"] = bool(torch.equal(bits(got0), bits(signed[tokens])))
            r["neg_zero_as_plus"] = bool(torch.equal(bits(got0), bits(signed[tokens] + 0.0)))
        out[shape_name] = r
    out["vocab_split"] = any(p.is_shard(0) for p in place)
    return out


def _rank(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(d, "store"),
                            rank=rank, world_size=world)
    try:
        res = {name: _port_case(d, name) for name in CASES}
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
def port_dir(tmp_path_factory):
    """The directory the eight ranks wrote ``port.json`` and the lookups to."""
    d = str(tmp_path_factory.mktemp("embed_mesh"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "port", d],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, f"port failed:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}"
    return d


@pytest.fixture(scope="module")
def port(port_dir):
    with open(os.path.join(port_dir, "port.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(CASES))
def test_meshed_lookup_is_bitwise_unmeshed(port, name, shape):
    got = port[name]
    assert got["table_negative_zeros"] == 0
    assert got[shape]["bitwise"]
    assert got[shape]["plain_tokens_bitwise"]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(CASES))
def test_meshed_lookup_is_bitwise_the_reference(port, port_dir, name, shape):
    import jax.numpy as jnp

    from repro.models import modules

    table = np.random.default_rng(SEED).standard_normal((port[name]["rows"], port[name]["d_model"]),
                                                        dtype=np.float32)
    tokens = np.load(os.path.join(port_dir, f"{name}_{shape}_tokens.npy"))
    got = np.load(os.path.join(port_dir, f"{name}_{shape}_got.npy"))
    want = np.asarray(modules.embed(jnp.asarray(table), jnp.asarray(tokens)))
    assert want.dtype == got.dtype == np.float32 and want.shape == got.shape
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("name", list(CASES))
def test_cases_cover_split_and_whole_vocab(port, name):
    assert port[name]["vocab_split"] == (name in ("qwen", "dbrx", "uneven"))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(CASES))
def test_lookup_never_indexes_the_dtensor_table(port, name, shape):
    ops = port[name][shape]["table_ops"]
    assert not [op for op in ops if op.startswith(("aten.index.", "aten.embedding."))], ops


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(CASES))
def test_no_collective_moves_the_table(port, name, shape):
    got = port[name]
    sizes = [nbytes for _, nbytes, _ in got[shape]["collectives"]]
    assert max(sizes, default=0) < got["table_bytes"], got[shape]["collectives"]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(CASES))
def test_result_shards_the_embed_dim(port, name, shape):
    got = port[name]
    want = ["Shard(dim=2)" if "Shard" in p else "Replicate()" for p in got["table_placements"]]
    assert got[shape]["placements"] == want


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(CASES))
def test_table_gradient_is_bitwise_unmeshed(port, name, shape):
    got = port[name]
    assert got[shape]["grad_bitwise"]
    assert got[shape]["grad_placements"] == got["table_placements"]


@pytest.mark.parametrize("name", list(CASES))
def test_negative_zero_row_comes_back_positive_only_where_the_vocab_splits(port, name):
    for shape in SHAPES:
        got = port[name][shape]
        assert got["neg_zero_as_plus"] if port[name]["vocab_split"] else got["neg_zero_kept"]


if __name__ == "__main__":
    if sys.argv[1] == "port":
        _port_main(sys.argv[2])
    else:
        raise SystemExit(f"usage: {sys.argv[0]} port DIR")
