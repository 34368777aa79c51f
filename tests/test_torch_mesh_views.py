"""No view of a ``DTensor`` merges a sharded dim into the dim before it.

``torch.matmul`` and ``torch.einsum`` fold their operands' leading dims with
``aten.view`` / ``aten._unsafe_view``.  When a mesh shards a dim that such a
view merges into the dim before it (a ``(B, S, D)`` activation sharded over
'data' on B and over 'model' on S, flattened to ``(B·S, D)``), DTensor's
rule decides: torch 2.13 flattens it through a strided shard, the card's
2.11 refuses ("Sharding propagation failed for aten.view.default(...
S(0)S(1) ...)"), so the dry-run's train and prefill cells ran in one
version only (and Mamba's decode cells: the state read's einsum folds the
batch and the heads).  The port gathers such dims before the product
(``context.merge_ready``, ``merge_ready_grad``) or runs the block on local
tensors (``ssm._ssd_region``, ``ssm._read_state``), whatever the version's
rule.

A ``TorchDispatchMode`` records every ``aten.view``, ``aten._unsafe_view``
and ``aten.reshape`` whose ``DTensor`` input has a dim longer than 1, and
sharded over a mesh dim of more than one rank, that the output merges with
an earlier dim longer than 1 (size-1 dims merge freely).  The reduced train,
prefill and decode cells of four families (and qwen2.5-3b's under ``--opt``'s
triangular attention) run forward and backward on the fake
(2, 4) mesh of ``tests/test_torch_dryrun.py`` under ``count_fn``, as the
dry-run runs them; nothing may be recorded.  The train cell takes 4
sequences in 2 microbatches, so each microbatch (2 sequences) splits
over 'data' as the full cell's 32 do over 16.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, specs

MESH = (2, 4)
# name → (arch, overrides of its reduced config); "qwen-tri" is ``--opt``'s
# triangular attention, its 16-token chunks a quarter of the sequence
ARCHS = {
    "qwen2.5-3b": ("qwen2.5-3b", {}),
    "dbrx-132b": ("dbrx-132b", {}),
    "mamba2-2.7b": ("mamba2-2.7b", {}),
    "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {}),
    "qwen-tri": ("qwen2.5-3b", {"attention_impl": "blockwise_tri", "attention_chunk": 16}),
}
REDUCED = {"train": (64, 4), "prefill": (64, 4), "decode": (64, 4)}  # (seq, batch)
MICROBATCHES = 2  # the train cell's: each of 2 sequences, split over 'data' as the full cell's 32
VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
         torch.ops.aten.reshape.default)


def merged_groups(src: tuple, dst: tuple) -> list[list[int]]:
    """The groups of ``src`` dims that a view to ``dst`` merges into one
    dim (each group more than one dim long); dims of size 1 are left out."""
    a = [(d, n) for d, n in enumerate(src) if n != 1]
    b = [n for n in dst if n != 1]
    groups, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        group, pa, pb = [a[i][0]], a[i][1], b[j]
        while pa != pb:
            if pa < pb:
                i += 1
                group.append(a[i][0])
                pa *= a[i][1]
            else:
                j += 1
                pb *= b[j]
        if len(group) > 1:
            groups.append(group)
        i, j = i + 1, j + 1
    return groups


def test_merged_groups():
    assert merged_groups((2, 64, 64), (128, 64)) == [[0, 1]]
    assert merged_groups((1, 64, 64), (64, 64)) == []
    assert merged_groups((4, 8, 8, 8, 8, 1), (256, 8, 8)) == [[0, 1, 2]]
    assert merged_groups((8, 64), (8, 4, 16)) == []  # a split merges nothing
    assert merged_groups((2, 3, 4), (6, 2, 2)) == [[0, 1]]


class ViewRecord(TorchDispatchMode):
    """(op, input shape, output shape, placements) of each view that merges
    a sharded dim into the dim before it."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.distributed.context import is_dtensor

        x = args[0] if args else None
        if func in VIEWS and is_dtensor(x):  # recorded before DTensor's rule may refuse it
            dst = [int(n) for n in args[1]]
            if -1 in dst:
                dst[dst.index(-1)] = x.numel() // -torch.Size(dst).numel()
            sharded = {getattr(p, "dim", None) for m, p in enumerate(x.placements)
                       if p.is_shard() and x.device_mesh.size(m) > 1}
            if any(d in sharded for g in merged_groups(tuple(x.shape), tuple(dst)) for d in g[1:]):
                self.hits.append((str(func), tuple(x.shape), tuple(dst), [repr(p) for p in x.placements]))
        return func(*args, **(kwargs or {}))


def _trace(name: str, kind: str) -> list:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import flops
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.launch.mesh import make_host_mesh

    seq, batch = REDUCED[kind]
    builder = {"train": "_build_train", "prefill": "_build_prefill", "decode": "_build_decode"}[kind]
    record = ViewRecord()
    with dryrun.fake_world(MESH[0] * MESH[1]):
        dev = dryrun.fake_device()
        mesh = make_host_mesh(*MESH, device=dev)
        with FakeTensorMode(allow_non_fake_inputs=True), activation_mesh(mesh):
            arch, overrides = ARCHS[name]
            extra = {"microbatches": MICROBATCHES} if kind == "train" else {}
            fn, args = getattr(specs, builder)(configs.reduced(arch, **overrides),
                                               ShapeConfig(kind, seq, batch, kind), mesh, dev, **extra)

            def step(*a):
                with record:  # above count_fn's mode: it sees each op at its DTensor level
                    return fn(*a)

            got = flops.count_fn(step, *args)
    assert got["flops"] > 0
    return record.hits


@pytest.mark.parametrize("kind", list(REDUCED))
@pytest.mark.parametrize("name", list(ARCHS))
def test_no_view_merges_a_sharded_dim(name, kind):
    hits = _trace(name, kind)
    assert not hits, f"{len(hits)} views, first: {hits[:4]}"


def test_the_record_sees_a_merged_sharded_dim():
    """The mode records the fault the guard is for: ``x @ w`` with ``x``
    sharded over both mesh dims, on B and on S."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.context import as_dtensor, merge_ready
    from repro_torch.launch.mesh import make_host_mesh

    with dryrun.fake_world(MESH[0] * MESH[1]):
        mesh = make_host_mesh(*MESH, device=dryrun.fake_device())
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = as_dtensor(torch.zeros(4, 8, 16), mesh).redistribute(mesh, [Shard(0), Shard(1)])
            w = as_dtensor(torch.zeros(16, 8), mesh)
            caught, clean = ViewRecord(), ViewRecord()
            with caught:
                try:  # a torch whose rule refuses the view raises here
                    x @ w
                except RuntimeError:
                    pass
            with clean:
                y = merge_ready(x) @ w
    assert caught.hits and caught.hits[0][1:3] == ((4, 8, 16), (32, 16))
    assert not clean.hits and tuple(y.shape) == (4, 8, 8)
