"""Multi-tenant slab arena — many growable arrays, one device pool
(port of ``repro.pool``).

One pre-carved pool of fixed-size slabs backs a whole fleet of logical
growable arrays: growth is "claim a slab" through a free-list bitmap instead
of a per-array bucket chain, so fleet capacity is bounded by live data + one
slab per array.
"""
from repro_torch.pool.arena import (
    ArenaGGArray,
    SlabArena,
    SlabPool,
    grow_pool,
    init_pool,
)
from repro_torch.pool.extents import (
    EXTENT_SCHEDULES,
    ExtentPool,
    grow_extents,
    init_extent_pool,
    is_extent_schedule,
    plan_extents,
)
from repro_torch.pool.planner import (
    PageBook,
    QuotaExceeded,
    SlabAllocator,
    TenantPlanner,
    growth_amount,
)

__all__ = [
    "ArenaGGArray",
    "SlabArena",
    "SlabPool",
    "ExtentPool",
    "EXTENT_SCHEDULES",
    "SlabAllocator",
    "TenantPlanner",
    "PageBook",
    "QuotaExceeded",
    "init_pool",
    "init_extent_pool",
    "grow_pool",
    "grow_extents",
    "plan_extents",
    "is_extent_schedule",
    "growth_amount",
]
