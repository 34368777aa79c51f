"""Telemetry of the port (``repro.obs``): the metrics registry, span tracing
and the serving timeline.  The flight recorder and the device counter plane
(K15) come with slice 4 (ROADMAP.md)."""
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    GaugeFn,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from repro_torch.obs.timeline import ServingTimeline
from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "GaugeFn",
    "Histogram",
    "MetricsRegistry",
    "ServingTimeline",
    "Span",
    "Tracer",
    "default_registry",
]
