"""The paper's own experimental configuration (§VI) — port of
``repro/configs/ggarray_demo.py``, field for field.

Start size 1e6, duplicate 10× to 1.024e9; GGArray variants with 32 and 512
LFVectors; B0 sized so the initial size fits the first bucket chain.  The
benchmark harness scales ``start_size`` down for CPU wall-clock sanity while
keeping the duplication structure identical.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GGArrayDemoConfig:
    start_size: int = 1_000_000
    duplications: int = 10
    nblocks_variants: tuple[int, ...] = (32, 512)
    b0_per_block: int = 64
    rw_op_repeats: int = 30  # the paper's "+1, 30 times" read/write kernel


CONFIG = GGArrayDemoConfig()
