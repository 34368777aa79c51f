"""Theoretical memory usage (paper §V, Fig. 3) — port of ``repro.core.theory``.

Scenario: an application starts from ``n0`` elements and performs insertions
whose total count is ``n0 * F`` with ``F ~ LogNormal(mu=0, sigma)``.  A static
array must pre-allocate for the (1 - fail_rate) quantile of ``F`` to fail at
most ``fail_rate`` of the time; the semi-static array doubles to the next
power-of-two multiple; GGArray allocates geometric buckets and stays below
2× + B0 of the realized size.  All formulas are analytic where possible and
Monte-Carlo verified in the benchmark.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import indexing

__all__ = ["MemoryModel", "memory_curves"]


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    n0: int = 1_000_000
    nblocks: int = 512
    b0: int = 8
    fail_rate: float = 0.01

    # -- per-structure capacity for a *realized* final size s -------------
    def ggarray_capacity(self, s: float) -> float:
        """Uniform-level bucket capacity for total size ``s`` spread evenly."""
        per_block = max(int(math.ceil(s / self.nblocks)), 1)
        nb = indexing.min_buckets_for(self.b0, per_block)
        return self.nblocks * indexing.capacity(self.b0, max(nb, 1))

    def semistatic_capacity(self, s: float, start: float | None = None) -> float:
        """Doubling from ``start`` (default n0) to cover ``s``."""
        cap = float(start if start is not None else self.n0)
        while cap < s:
            cap *= 2
        return cap

    def static_capacity(self, sigma: float) -> float:
        """Pre-allocation for a (1-fail_rate) success probability (Fig. 3)."""
        z = _norm_ppf(1.0 - self.fail_rate)
        return self.n0 * math.exp(sigma * z)

    # -- expected capacities under F ~ LogNormal(0, sigma) ----------------
    def sample_final_sizes(self, sigma: float, rng: np.random.Generator, n: int) -> np.ndarray:
        return self.n0 * rng.lognormal(mean=0.0, sigma=sigma, size=n)

    def expected(self, sigma: float, samples: int = 4096, seed: int = 0) -> dict[str, float]:
        rng = np.random.default_rng(seed)
        s = self.sample_final_sizes(sigma, rng, samples)
        optimal = float(np.mean(s))
        gg = float(np.mean([self.ggarray_capacity(x) for x in s]))
        semi = float(np.mean([self.semistatic_capacity(x) for x in s]))
        return {
            "optimal": optimal,
            "ggarray": gg,
            "semistatic": semi,
            "static": self.static_capacity(sigma),
            "ggarray_over_optimal": gg / optimal,
            "static_over_optimal": self.static_capacity(sigma) / optimal,
        }


def _norm_ppf(p: float) -> float:
    """Acklam's inverse-normal approximation (no scipy in this container)."""
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        )
    if p <= phigh:
        q = p - 0.5
        r = q * q
        return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / (
            ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1
        )
    q = math.sqrt(-2 * math.log(1 - p))
    return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
        (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
    )


def memory_curves(
    sigmas: np.ndarray | None = None, model: MemoryModel | None = None
) -> dict[str, np.ndarray]:
    """Fig. 3 data: memory/optimal ratios across sigma ∈ [0, 2]."""
    model = model or MemoryModel()
    sigmas = np.linspace(0.0, 2.0, 9) if sigmas is None else sigmas
    rows = [model.expected(float(s)) for s in sigmas]
    return {
        "sigma": np.asarray(sigmas),
        **{k: np.asarray([r[k] for r in rows]) for k in rows[0]},
    }
