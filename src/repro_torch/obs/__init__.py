"""Telemetry of the port — so far only the metrics registry that
``runtime.FreezeStats`` reads (port of ``repro.obs.registry``)."""
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    GaugeFn,
    Histogram,
    MetricsRegistry,
    default_registry,
)

__all__ = [
    "Counter",
    "Gauge",
    "GaugeFn",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
]
