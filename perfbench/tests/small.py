"""Small copies of the cells' configurations, for the CPU."""
from __future__ import annotations

import copy
import time

from perfbench import harness


def sec6() -> dict:
    c = harness.load_json(harness.ROOT / "perfbench/configs/ggarray-sec6.json")
    c.update(start_size=1000, duplications=4, nblocks=8, b0_per_block=8)
    return c


def run(cell: str, seed: int = 5, seconds: float = 1.5, config: dict | None = None, control: bool = False,
        trace: bool = False):
    """One run of ``cell`` on the CPU with its small copies → (line, record)."""
    config = sec6() if config is None else config
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    return harness.run_cell(cell, seed, seconds, trace, t_start=time.perf_counter(), device="cpu",
                            bench=bench, config=copy.deepcopy(config), control=control)
