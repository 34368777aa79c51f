"""Telemetry of the port (``repro.obs``): the metrics registry, span tracing,
the serving timeline, the flight recorder and the device counter plane
(K15, ``obs.device``)."""
from repro_torch.obs import device
from repro_torch.obs.device import DeviceCounterPlane
from repro_torch.obs.flightrec import FlightRecorder
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
    "DeviceCounterPlane",
    "FlightRecorder",
    "Gauge",
    "GaugeFn",
    "Histogram",
    "MetricsRegistry",
    "ServingTimeline",
    "Span",
    "Tracer",
    "default_registry",
    "device",
]
