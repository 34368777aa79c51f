"""Phase-aware runtime for the paper's two-phase usage pattern (§VI.D) —
port of ``repro.runtime``."""
from repro_torch.runtime.phases import (
    FreezeStats,
    FrozenArray,
    Phase,
    PhaseError,
    TwoPhasePipeline,
)

__all__ = ["FreezeStats", "FrozenArray", "Phase", "PhaseError", "TwoPhasePipeline"]
