"""Process-local metrics registry (port of ``repro.obs.registry``).

Counters, gauges, histograms with labels.

One registry per observed component (an engine, an arena, a pipeline — or the
process-wide :func:`default_registry`).  Metrics are host-side Python state:
recording is a dict update, never a device operation, so instrumentation is
safe on the append/decode hot path (the zero-sync contract, DESIGN.md §9).

The one deliberate exception is :meth:`Counter.add_lazy`: device scalars
(e.g. the live-count a freeze leaves behind) are *accumulated as device
values* and summed into the host total only when the metric is read or the
registry snapshots — so the transfer happens at an explicit drain point the
caller chose, never inside the recording call.  This is the registry-level
version of the ``FreezeStats.elements_frozen`` pattern (DESIGN.md §2).

Label values are part of the series key (``counter.inc(site="stop_drain")``);
cardinality is the caller's responsibility (label requests only in tests and
timelines, never unbounded user input).  Not thread-safe — the serving loop
is single-threaded host code.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "Counter",
    "Gauge",
    "GaugeFn",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
]

_Key = tuple  # sorted (label, value) pairs — the series key


def _key(labels: dict) -> _Key:
    return tuple(sorted(labels.items()))


def _series_name(name: str, key: _Key) -> str:
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


class _Metric:
    kind = "?"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def snapshot_into(self, out: dict) -> None:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic count per label set; supports lazy device-scalar adds."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: dict[_Key, float] = {}
        self._lazy: dict[_Key, list] = {}  # pending device scalars

    def inc(self, n: float = 1, **labels) -> None:
        k = _key(labels)
        self._vals[k] = self._vals.get(k, 0) + n

    def add_lazy(self, scalar: Any, **labels) -> None:
        """Accumulate a device scalar (a 0-d tensor) without reading it.

        The value stays on device until :meth:`value`/:meth:`total`/
        ``snapshot`` drains it (one transfer for all pending scalars).
        """
        self._lazy.setdefault(_key(labels), []).append(scalar)

    def _drain(self) -> None:
        for k, pend in list(self._lazy.items()):
            if not pend:
                continue
            tot = pend[0] if len(pend) == 1 else torch.stack(pend).sum()
            self._vals[k] = self._vals.get(k, 0) + int(tot.item())
            self._lazy[k] = []

    def value(self, **labels) -> float:
        self._drain()
        return self._vals.get(_key(labels), 0)

    def total(self) -> float:
        """Sum across every label set (drains pending device scalars)."""
        self._drain()
        return sum(self._vals.values())

    def snapshot_into(self, out: dict) -> None:
        self._drain()
        for k, v in sorted(self._vals.items()):
            out[_series_name(self.name, k)] = v


class Gauge(_Metric):
    """Last-set value per label set, with a high-water mark."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: dict[_Key, float] = {}
        self._hwm: dict[_Key, float] = {}

    def set(self, v: float, **labels) -> None:
        k = _key(labels)
        self._vals[k] = v
        if v > self._hwm.get(k, float("-inf")):
            self._hwm[k] = v

    def value(self, **labels) -> float:
        return self._vals.get(_key(labels), 0)

    def hwm(self, **labels) -> float:
        """High-water mark over every ``set`` so far."""
        return self._hwm.get(_key(labels), 0)

    def snapshot_into(self, out: dict) -> None:
        for k, v in sorted(self._vals.items()):
            out[_series_name(self.name, k)] = {"value": v, "hwm": self._hwm[k]}


class GaugeFn(_Metric):
    """Gauge computed by a callback at snapshot time (zero recording cost).

    The hook for host counters owned elsewhere — e.g. a
    ``CapacityPlanner.host_syncs`` int — so existing accounting surfaces in
    the catalog without the owner importing ``obs``.
    """

    kind = "gauge"

    def __init__(self, name: str, fn: Callable[[], float], help: str = ""):
        super().__init__(name, help)
        self.fn = fn

    def value(self) -> float:
        return self.fn()

    def hwm(self) -> float:
        return self.fn()

    def snapshot_into(self, out: dict) -> None:
        v = self.fn()
        out[self.name] = {"value": v, "hwm": v}


def _summary(vals: list, count: int | None = None, total: float | None = None) -> dict:
    """Summary stats; ``count``/``total`` override the (possibly sampled)
    raw list with the exact running values a bounded reservoir keeps."""
    arr = np.asarray(vals, np.float64)
    n = int(arr.size) if count is None else int(count)
    s = float(arr.sum()) if total is None else float(total)
    return {
        "count": n,
        "sum": s,
        "mean": s / n if n else 0.0,
        "p50": float(np.quantile(arr, 0.50)),
        "p95": float(np.quantile(arr, 0.95)),
        "max": float(arr.max()),
    }


# Per-labelset sample cap: below it the histogram stores every observation
# (exact quantiles); past it, Vitter's algorithm R keeps a uniform reservoir
# so long serving runs hold O(1) memory per series instead of O(steps).
RESERVOIR_CAP = 4096


class Histogram(_Metric):
    """Sampled histogram per label set with exact count/sum.

    Memory per label set is bounded at :data:`RESERVOIR_CAP` samples: until
    the cap every observation is stored (quantiles are exact); past it the
    stored samples become a uniform reservoir (algorithm R, deterministic
    per-metric RNG) — quantiles turn into reservoir estimates while
    ``count``/``sum``/``mean`` stay exact running totals.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: dict[_Key, list[float]] = {}  # bounded reservoirs
        self._count: dict[_Key, int] = {}  # exact observation counts
        self._sum: dict[_Key, float] = {}  # exact running sums
        import random
        import zlib

        # deterministic per-metric stream (hash() is process-salted)
        self._rng = random.Random(zlib.crc32(name.encode()))

    def observe(self, v: float, **labels) -> None:
        k = _key(labels)
        v = float(v)
        n = self._count.get(k, 0) + 1
        self._count[k] = n
        self._sum[k] = self._sum.get(k, 0.0) + v
        vals = self._vals.setdefault(k, [])
        if len(vals) < RESERVOIR_CAP:
            vals.append(v)
        else:  # algorithm R: keep each of the n seen with prob CAP/n
            j = self._rng.randrange(n)
            if j < RESERVOIR_CAP:
                vals[j] = v

    def values(self, **labels) -> list[float]:
        """Stored samples of one label set (every observation until
        :data:`RESERVOIR_CAP`, a uniform reservoir past it); with no
        labels, every stored sample merged."""
        if labels:
            return list(self._vals.get(_key(labels), []))
        return [v for vals in self._vals.values() for v in vals]

    def count(self, **labels) -> int:
        """Exact observation count (not bounded by the reservoir)."""
        if labels:
            return self._count.get(_key(labels), 0)
        return sum(self._count.values())

    def sum(self, **labels) -> float:
        """Exact running sum (not bounded by the reservoir)."""
        if labels:
            return self._sum.get(_key(labels), 0.0)
        return sum(self._sum.values())

    def quantile(self, q: float, **labels) -> float:
        """Quantile over the stored samples — exact while the label set has
        at most :data:`RESERVOIR_CAP` observations, a uniform-reservoir
        estimate beyond that."""
        vals = self.values(**labels)
        if not vals:
            raise ValueError(f"histogram {self.name}: no samples for {labels}")
        return float(np.quantile(np.asarray(vals, np.float64), q))

    def snapshot_into(self, out: dict) -> None:
        merged = self.values()
        if not merged:
            return
        summary = _summary(merged, self.count(), self.sum())
        if len(self._vals) > 1 or _key({}) not in self._vals:
            summary["series"] = {
                _series_name(self.name, k): _summary(
                    v, self._count.get(k, len(v)), self._sum.get(k)
                )
                for k, v in sorted(self._vals.items())
                if v
            }
        out[self.name] = summary


class MetricsRegistry:
    """Get-or-create metric namespace + one-call JSON-safe snapshot."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str) -> Any:
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"not {cls.kind}"
            )
        elif help and not m.help:
            m.help = help
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def gauge_fn(self, name: str, fn: Callable[[], float], help: str = "") -> GaugeFn:
        m = self._metrics.get(name)
        if m is None:
            m = GaugeFn(name, fn, help)
            self._metrics[name] = m
        elif isinstance(m, GaugeFn):
            m.fn = fn
        else:
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """→ {"counters": {...}, "gauges": {...}, "histograms": {...}}.

        This is a drain point: pending lazy device scalars are materialized
        here (and only here / on explicit metric reads).
        """
        out: dict[str, dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        bucket = {"counter": "counters", "gauge": "gauges", "histogram": "histograms"}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            m.snapshot_into(out[bucket[m.kind]])
        return out


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (component-scoped registries are separate)."""
    return _default
