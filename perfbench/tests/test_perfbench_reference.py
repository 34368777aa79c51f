"""The plain reference and the frozen arithmetic against the program, at
small sizes on the CPU."""
import pytest
import torch

from perfbench.arith import kernel_bytes, peaks
from perfbench.drivers import twophase_jobs
from perfbench.reference import sec6_order


@pytest.mark.parametrize("nblocks,start,dups", [(8, 1000, 4), (5, 333, 3), (16, 64, 2)])
def test_sec6_order_matches_a_small_pipeline(nblocks, start, dups):
    from repro_torch.runtime import TwoPhasePipeline

    sizes = twophase_jobs.duplication_sizes(start, dups)
    gen = torch.Generator().manual_seed(nblocks)
    waves, pipe = [], TwoPhasePipeline(nblocks, b0=8, device="cpu")
    for size in sizes:
        m = -(-size // nblocks)
        waves.append(torch.rand((nblocks, m), generator=gen))
        pipe.append(waves[-1], (torch.arange(nblocks * m) < size).reshape(nblocks, m), method="auto")
    pipe.freeze()
    pipe.map_frozen(lambda x: x + 1 + 1 + 1)
    data = pipe.frozen.data
    got = sec6_order.frozen_mismatches(data, waves, sizes, 3)
    assert got == {"mismatches": 0, "tail_nonzero": 0, "expected_elements": sum(sizes)}
    assert torch.equal(sec6_order.rebuild(waves, sizes, 3, data.shape[0], torch.float32), data)
    assert sec6_order.frozen_mismatches(sec6_order.rebuild(waves, sizes, 3, data.shape[0], torch.bfloat16),
                                        waves, sizes, 3)["mismatches"] > 0


def test_bounds_take_the_larger_term():
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(0, flops=989e12) == pytest.approx(1.0)
    # K3: 512 blocks x 1e6 lanes of f32, all live: bytes bound it
    b = kernel_bytes.push_back_bound_s(512, 10 ** 6, 512 * 10 ** 6, 4)
    assert b == pytest.approx((512e6 * 13 + 8 * 512) / 3.35e12)
