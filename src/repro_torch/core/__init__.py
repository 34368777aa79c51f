"""GGArray core — port of ``repro.core`` (indexing, theory, insertion, ggarray,
lfvector, baselines)."""
from repro_torch.core.ggarray import (
    PUSH_BACK_METHODS,
    CapacityPlanner,
    GGArray,
    append,
    block_starts,
    ensure_capacity,
    flatten,
    from_flat,
    gather_block,
    grow,
    init,
    map_elements,
    memory_elems,
    needs_grow,
    push_back,
    read_global,
    reserve,
    total_size,
    write_global,
)
from repro_torch.core.baselines import SemiStaticArray, StaticArray, static_init, static_push_back
from repro_torch.core.insertion import INSERTION_METHODS, insertion_offsets
from repro_torch.core.lfvector import LFVector

__all__ = [
    "GGArray", "init", "push_back", "append", "grow", "needs_grow",
    "ensure_capacity", "reserve", "CapacityPlanner", "PUSH_BACK_METHODS",
    "flatten", "from_flat", "read_global", "write_global", "gather_block",
    "map_elements", "total_size", "memory_elems", "block_starts",
    "StaticArray", "SemiStaticArray", "static_init", "static_push_back",
    "insertion_offsets", "INSERTION_METHODS", "LFVector",
]
