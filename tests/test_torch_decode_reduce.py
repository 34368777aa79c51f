"""The decode step's residual adds on a mesh: every block's output reaches
the residual stream reduced (``serving.steps.decode_step``), never as a
``Partial`` DTensor whose pending sums DTensor's rule for the add would
place (torch 2.11 all-reduces them at the add, 2.13 at the next norm, so
the dry-run's collective bytes depended on the version).

Each case traces a reduced config's decode cell (``specs._build_decode``)
on PyTorch's ``fake`` process group of eight ranks, a (2, 4) ('data',
'model') mesh, as ``tests/test_torch_dryrun.py`` does, under
``tools/dryrun_placements.py``'s recorder: every op that receives a
``DTensor``, with its operands' global shapes and placements.  A residual
add is an ``aten.add.Tensor`` both of whose operands have the residual
stream's global shape (B, 1, D); a bias add has a (D,) operand.  No
activation (SiLU, GELU, ReLU, sigmoid, softplus) receives one either.
"""
import importlib.util
import os

import pytest

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, specs

HERE = os.path.dirname(os.path.abspath(__file__))
MESH = (2, 4)
SEQ, BATCH = 64, 4
# the attention-only archs and one of each other layer kind: MoE, Mamba,
# the hybrid, the encoder-decoder's cross-attention, the prefix embeddings
ARCHS = ["qwen2.5-3b", "dbrx-132b", "mamba2-2.7b", "jamba-v0.1-52b", "seamless-m4t-large-v2",
         "internvl2-26b", "starcoder2-3b"]


ACTIVATIONS = ("aten.silu.default", "aten.gelu.default", "aten.relu.default", "aten.sigmoid.default",
               "aten.softplus.default", "aten.logaddexp.default")  # Mamba's softplus: logaddexp(x, 0)


def _recorder():
    spec = importlib.util.spec_from_file_location(
        "dryrun_placements", os.path.join(HERE, "..", "tools", "dryrun_placements.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.recorder()


@pytest.fixture(scope="module")
def records():
    """(arch, mesh) → what ``_record`` recorded, once each."""
    return {}


def _record(records: dict, arch: str, mesh: str = "2x4") -> tuple[list, object, int]:
    """(every DTensor op of a decode step, as recorded; its config; its
    batch): the reduced config on the (2, 4) mesh, or on ``mesh`` "16x16"
    or "2x16x16" the config at full width cut to one period at
    ``decode_32k``'s batch, as ``tools/dryrun_placements.py record`` runs
    it."""
    if (arch, mesh) in records:
        return records[arch, mesh]
    full = mesh != "2x4"
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import flops
    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    if full:
        cfg = configs.get(arch)
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.layout), n_enc_layers=min(cfg.n_enc_layers, 1))
        shape = SHAPES["decode_32k"]
    else:
        cfg, shape = configs.reduced(arch), ShapeConfig("decode", SEQ, BATCH, "decode")
    mode, ops = _recorder()
    ranks = {"2x4": MESH[0] * MESH[1], "16x16": 256, "2x16x16": 512}[mesh]
    with dryrun.fake_world(ranks):
        dev = dryrun.fake_device()
        dmesh = (make_production_mesh(multi_pod=ranks == 512, device=dev) if full
                 else make_host_mesh(*MESH, device=dev))
        with FakeTensorMode(allow_non_fake_inputs=True), activation_mesh(dmesh):
            step, args = specs._build_decode(cfg, shape, dmesh, dev)

            def run(*a):
                with mode:  # above count_fn's mode: each op at its DTensor level
                    return step(*a)

            flops.count_fn(run, *args)
    records[arch, mesh] = ops, cfg, shape.global_batch
    return records[arch, mesh]


def _partial(operand) -> bool:
    return isinstance(operand, list) and "Partial" in str(operand[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_residual_adds_receive_no_partial_operand(records, arch):
    ops, cfg, batch = _record(records, arch)
    stream = [batch, 1, cfg.d_model]
    adds = [op for op in ops if op[0] == "aten.add.Tensor" and len(op[1]) >= 2
            and all(isinstance(a, list) and a[0] == stream for a in op[1][:2])]
    # each layer adds at least its mixer's output and (but a Mamba layer)
    # its MLP's: the record is not empty
    assert len(adds) >= cfg.n_layers, (len(adds), cfg.n_layers)
    bad = [op for op in adds if any(_partial(a) for a in op[1][:2])]
    assert not bad, bad[:3]


@pytest.mark.parametrize("arch, mesh", [(a, "2x4") for a in ARCHS]
                         + [("mamba2-2.7b", "16x16"), ("jamba-v0.1-52b", "2x16x16")])
def test_decode_activations_receive_no_partial_operand(records, arch, mesh):
    """Nor does an activation: DTensor must reduce pending sums before a
    nonlinear op, and torch versions choose how: dbrx's expert gate;
    Mamba's gate, which meets them at full width only, and its dt, on the
    2×16×16 mesh only (2.13 reduce-scattered them, 2.11 all-reduced)."""
    ops, _, _ = _record(records, arch, mesh)
    acts = [op for op in ops if op[0] in ACTIVATIONS]
    assert acts, "no activation recorded"
    bad = [op for op in acts if any(_partial(a) for a in op[1])]
    assert not bad, bad[:3]
