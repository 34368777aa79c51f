"""Roofline terms of a step — port of ``repro/analysis/roofline.py``.

Terms per (arch × shape × mesh) cell, all in seconds per step:

  compute    = FLOPs_per_device / peak_FLOPs
  memory     = bytes_per_device / HBM_bw
  collective = Σ collective_bytes_per_device × traffic_factor / link_bw

``HW`` holds the data-sheet peaks of one NVIDIA H100 SXM5 (80 GB HBM3):
989e12 dense bf16 FLOP/s (the tensor cores, no sparsity), 3.35e12 B/s of
HBM3, and NVLink 4 at 450e9 B/s in each direction (900 GB/s a card, all to
all within one 8-card host).  They are peaks at the full 700 W power limit,
not measurements.  A collective group wider than 8 ranks crosses hosts,
over a slower network; that is not modelled, just as the reference models
no link slower than its ICI.

Collective bytes come from the record that ``analysis.flops.count_fn``
keeps of every collective the step issued (op kind, result bytes, group
size), weighted by the standard ring traffic factors: all-reduce
2(n−1)/n, all-gather, reduce-scatter and all-to-all (n−1)/n, permute 1,
and a group of one 0.  Nothing in the port emits HLO, so the port keeps no
copy of the reference's HLO parser: a Python loop runs its collectives as
often as it runs, and the record holds each one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

__all__ = ["HW", "collective_bytes", "roofline_terms", "model_flops", "COLLECTIVE_KINDS"]

# NVIDIA H100 SXM5 data-sheet peaks (700 W)
PEAK_FLOPS = 989e12  # dense bf16
HBM_BW = 3.35e12  # B/s, HBM3
LINK_BW = 450e9  # B/s, NVLink 4, each direction

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW


def _traffic_factor(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op in ("all-gather", "reduce-scatter", "all-to-all"):
        return (n - 1) / n
    return 1.0  # collective-permute


def collective_bytes(record: Iterable[tuple[str, int, int]]) -> dict[str, float]:
    """Per-device weighted collective bytes by op kind, from a record of
    ``(op kind, result bytes, group size)`` — one entry a collective run
    (``count_fn(...)["collectives"]``)."""
    out: dict[str, float] = {"total_weighted": 0.0, "total_raw": 0.0}
    for op, raw, n in record:
        if op not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective {op!r}; options: {COLLECTIVE_KINDS}")
        w = raw * _traffic_factor(op, n)
        out[op] = out.get(op, 0.0) + w
        out["total_weighted"] += w
        out["total_raw"] += raw
    return out


def roofline_terms(cost: dict[str, Any], coll: dict[str, float], hw: HW = HW()) -> dict[str, float]:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(coll.get("total_weighted", 0.0))
    compute_s = flops / hw.peak_flops
    memory_s = byts / hw.hbm_bw
    coll_s = cbytes / hw.link_bw
    bound = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", coll_s),
        key=lambda kv: kv[1],
    )[0]
    step_s = max(compute_s, memory_s, coll_s)
    return {
        "flops_per_device": flops,
        "bytes_per_device": byts,
        "collective_bytes_per_device": cbytes,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "bound": bound,
        "step_s_lower_bound": step_s,
    }


def model_flops(cfg, shape, chips: int) -> dict[str, float]:
    """Useful-model-FLOPs convention: train 6·N_active·D tokens; prefill
    2·N_active·D; decode 2·N_active·B."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    if shape.kind == "train":
        total = 6.0 * n_active * shape.seq_len * shape.global_batch
    elif shape.kind == "prefill":
        total = 2.0 * n_active * shape.seq_len * shape.global_batch
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return {
        "model_flops_total": total,
        "model_flops_per_device": total / chips,
        "params_total": counts["total"],
        "params_active": n_active,
    }
