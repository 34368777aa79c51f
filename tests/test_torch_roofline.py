"""The roofline machinery of the port (``repro_torch.analysis``) — mirrors
``tests/analysis/test_roofline.py``.

The reference parses collectives out of HLO text and counts FLOPs over a
jaxpr; the port records collectives and counts aten ops as a step runs
(``analysis.flops.count_fn``).  The collective cases run on PyTorch's
``fake`` process group of four ranks in this process
(``launch.dryrun.fake_world``, destroyed after the module).
"""
import numpy as np
import pytest
import torch

from repro.analysis import roofline as rroofline
from repro.configs.base import SHAPES as RSHAPES
from repro import configs as rconfigs
from repro_torch import configs
from repro_torch.analysis import flops, roofline
from repro_torch.configs.base import SHAPES
from repro_torch.kernels import common


@pytest.fixture(scope="module")
def group():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world

    with fake_world(4):
        yield dist.group.WORLD


def test_collective_record_weights_and_loops(group):
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    def f(x):
        a = funcol.all_gather_single(x, 1, group)  # (128, 256) f32
        b = funcol.all_reduce(x, "sum", group)  # (128, 64) f32
        for _ in range(5):  # a permute in a 5-trip loop
            dist.send(x, 1)
        return a + 0, b + 0

    got = flops.count_fn(f, torch.zeros(128, 64))
    assert [k for k, _, _ in got["collectives"]] == ["all-gather", "all-reduce"] + ["collective-permute"] * 5
    assert all(n == 4 for _, _, n in got["collectives"])
    out = roofline.collective_bytes(got["collectives"])
    ag = 128 * 256 * 4 * (3 / 4)  # all-gather (n-1)/n
    ar = 128 * 64 * 4 * (2 * 3 / 4)  # all-reduce 2(n-1)/n
    cp = 128 * 64 * 4 * 5  # permute inside a 5-trip loop
    assert out["all-gather"] == pytest.approx(ag)
    assert out["all-reduce"] == pytest.approx(ar)
    assert out["collective-permute"] == pytest.approx(cp)
    assert out["total_weighted"] == pytest.approx(ag + ar + cp)
    assert out["total_raw"] == 128 * 256 * 4 + 128 * 64 * 4 + 5 * 128 * 64 * 4


@pytest.mark.parametrize("n,factor", [(1, 0.0), (2, 0.5), (8, 7 / 8)])
def test_ring_factors_by_group_size(n, factor):
    out = roofline.collective_bytes([("all-gather", 1000, n), ("all-reduce", 1000, n),
                                     ("collective-permute", 1000, n)])
    assert out["all-gather"] == pytest.approx(1000 * factor)
    assert out["all-reduce"] == pytest.approx(2000 * factor)
    assert out["collective-permute"] == pytest.approx(0.0 if n == 1 else 1000)


def test_unknown_collective_kind_refused():
    with pytest.raises(ValueError):
        roofline.collective_bytes([("broadcast", 8, 4)])


def test_counter_multiplies_python_loops():
    w = torch.ones(64, 64)

    def stacked(x):
        for _ in range(12):
            x = x @ w
        return x

    got = flops.count_fn(stacked, torch.zeros(8, 64))
    assert got["flops"] == 12 * 2 * 8 * 64 * 64


def test_counter_sees_remat_recompute():
    from torch.utils.checkpoint import checkpoint

    w = torch.ones(32, 32)

    def f(x):
        return torch.sum(checkpoint(lambda y: torch.tanh(y @ w), x, use_reentrant=False))

    x = torch.zeros(4, 32, requires_grad=True)
    base = flops.count_fn(f, x)
    grad = flops.count_fn(lambda x: torch.autograd.grad(f(x), x)[0], x)
    # forward (1 product) vs remat gradient (forward + recompute + dx = 3;
    # w needs no gradient, so no dw product exists)
    assert grad["flops"] == 3 * base["flops"]


def test_roofline_terms_pick_dominant_bound():
    hw = roofline.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
    cost = {"flops": 989e12, "bytes accessed": 3.35e12 / 2}
    coll = {"total_weighted": 450e9 * 2}
    t = roofline.roofline_terms(cost, coll)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.5)
    assert t["collective_s"] == pytest.approx(2.0)
    assert t["bound"] == "collective" and t["step_s_lower_bound"] == pytest.approx(2.0)
    t = roofline.roofline_terms({"flops": 0.0, "bytes accessed": 3.35e12 * 3}, {})
    assert t["bound"] == "memory" and t["step_s_lower_bound"] == pytest.approx(3.0)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_equal_reference(arch, shape):
    for chips in (256, 512):
        got = roofline.model_flops(configs.get(arch), SHAPES[shape], chips)
        want = rroofline.model_flops(rconfigs.get(arch), RSHAPES[shape], chips)
        assert got == want


def _bytes(*shapes_dtypes) -> int:
    return sum(int(np.prod(s)) * torch.empty((), dtype=d).element_size() for s, d in shapes_dtypes)


def test_hbm_bytes_outputs_always_operands_for_contracting_ops():
    a, b = torch.zeros(8, 16), torch.zeros(16, 4)
    # an elementwise op: its output only
    assert flops.count_fn(lambda x: x + 1, a)["hbm_bytes"] == _bytes(((8, 16), torch.float32))
    # a product: operands and output
    got = flops.count_fn(lambda x, y: x @ y, a, b)
    assert got["hbm_bytes"] == _bytes(((8, 16), torch.float32), ((16, 4), torch.float32),
                                      ((8, 4), torch.float32))
    assert got["flops"] == 2 * 8 * 16 * 4
    # a reduction: operand and output
    assert flops.count_fn(lambda x: x.sum(0), a)["hbm_bytes"] == _bytes(((8, 16), torch.float32),
                                                                       ((16,), torch.float32))
    # a gather by index: operands and output
    idx = torch.tensor([0, 3])
    assert flops.count_fn(lambda x, i: x.index_select(0, i), a, idx)["hbm_bytes"] == _bytes(
        ((8, 16), torch.float32), ((2,), torch.int64), ((2, 16), torch.float32))


def test_hbm_bytes_views_and_empty_are_free():
    a = torch.zeros(8, 16)
    got = flops.count_fn(lambda x: x.view(16, 8).t()[:3].unsqueeze(0), a)
    assert got["hbm_bytes"] == 0 and got["flops"] == 0
    assert flops.count_fn(lambda x: torch.empty_like(x), a)["hbm_bytes"] == 0
    # a slicing copy (the reference's dynamic_update_slice): operand and output
    got = flops.count_fn(lambda x: x[:2].copy_(torch.ones(2, 16)), a)
    # ones' output, then copy_'s destination and source, and its output
    assert got["hbm_bytes"] == 2 * 16 * 4 * 4


def test_hand_written_kernel_counts_as_one_data_moving_op():
    x = torch.zeros(4, 8)

    def f(x):
        y = x * 2
        common.run_kernel("push_back", [x], plain=lambda: y, launch=lambda: y)
        return y

    got = flops.count_fn(f, x)
    assert got["hbm_bytes"] == 3 * 4 * 8 * 4  # x * 2's output, then the kernel's operand and output


def test_shape_rule_is_counted_once_on_fake_tensors():
    """On fake tensors K3's wrapper runs its plain version uncounted and
    notes one launch, with the in-place levels among operands and outputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.push_back import ops

    with FakeTensorMode():
        levels = (torch.zeros(2, 4), torch.zeros(2, 8))
        sizes = torch.zeros(2, dtype=torch.int32)
        elems, mask = torch.zeros(2, 1), torch.ones(2, 1, dtype=torch.bool)
        got = flops.count_fn(lambda: ops.push_back_fused(levels, sizes, 4, elems, mask), trace=True)
    kernel_ops = [op for op in got["ops"] if op[0].startswith("kernel.")]
    assert [op[0] for op in kernel_ops] == ["kernel.push_back"]
    levels_b = (2 * 4 + 2 * 8) * 4
    assert kernel_ops[0][3] == 2 * levels_b + 2 * 4 + 2 * 4 + 2 * 1 + 2 * 4 + 2 * 4
    assert got["hbm_bytes"] == kernel_ops[0][3]  # nothing else counted
