"""ServingTimeline — one registry + one tracer per observed component — port
of ``repro/obs/timeline.py``.

The bundle every instrumented surface owns (``BatchEngine.obs``,
``Engine.obs``): a :class:`~repro_torch.obs.registry.MetricsRegistry` for the
aggregate view (counters/gauges/histograms, the ``*Stats`` legacy views read
from it) and a :class:`~repro_torch.obs.trace.Tracer` for the per-step timeline
(spans, instants, per-step gauge samples → JSON + Chrome trace).

``gauge_sample`` is the bridge: it sets the registry gauge (so high-water
marks and the final snapshot agree) *and* appends a timeline counter sample
(so the per-step history is reconstructible) — one host float, recorded in
two places, which is what lets the acceptance test reconcile the timeline
against the legacy stats view exactly (DESIGN.md §9).

Everything here is host state; the zero-sync contract of ``obs`` holds:
no method issues a device→host transfer except ``snapshot()``/
``export_json()``, which are explicit drain points (lazy device counters
materialize there).  Every event also lands in the flight recorder's
bounded ring (``flight``), so a postmortem bundle has the recent timeline
with no extra call sites at the recording surfaces (DESIGN.md §9.y).
"""
from __future__ import annotations

import json

from repro_torch.obs.flightrec import FlightRecorder
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import Tracer

__all__ = ["ServingTimeline"]


class ServingTimeline:
    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        *,
        profiler_annotations: bool = False,
        flight_capacity: int = 256,
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = Tracer(profiler_annotations=profiler_annotations)
        self.flight = FlightRecorder(capacity=flight_capacity)

    # ---- recording -------------------------------------------------------
    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def event(self, name: str, **attrs) -> None:
        self.tracer.event(name, **attrs)
        self.flight.note(name, **attrs)

    def gauge_sample(self, name: str, value: float) -> None:
        """Set the registry gauge and log a timeline sample (one value)."""
        self.registry.gauge(name).set(value)
        self.tracer.sample(name, value)

    # ---- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Registry snapshot (the explicit lazy-counter drain point)."""
        return self.registry.snapshot()

    def export_json(self, path: str) -> str:
        """Metrics snapshot + full timeline as one JSON document."""
        payload = {"metrics": self.snapshot(), "timeline": self.tracer.to_json()}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        return path

    def export_chrome(self, path: str) -> str:
        """Chrome/Perfetto trace of the timeline (spans/events/samples)."""
        return self.tracer.export_chrome(path)
