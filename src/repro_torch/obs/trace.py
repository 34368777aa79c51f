"""Span tracing with JSON and Chrome/Perfetto trace export — port of
``repro/obs/trace.py``.

``Tracer`` records three host-side event kinds against one monotonic clock
(``time.perf_counter``, microsecond resolution in the export):

* **spans** — ``with tracer.span("prefill_chunk", request=rid):`` wall-clock
  intervals.  Spans nest via the context-manager stack, which is exactly the
  nesting Chrome's trace viewer reconstructs from ``ph: "X"`` duration
  events on one thread track.
* **instants** — ``tracer.event("admit", request=rid)`` point events
  (``ph: "i"``), the serving timeline's admit/evict/starvation markers.
* **counter samples** — ``tracer.sample("pool.utilization", 0.93)`` time
  series (``ph: "C"``), rendered as stacked graphs in the viewer — the
  per-step gauge track of the serving timeline.

Recording is append-to-a-list: no device contact, no synchronization, so
spans are safe around the decode hot loop (they time the *dispatch* path —
CUDA launches are asynchronous; call ``torch.cuda.synchronize()`` yourself
if you want device latency, and accept the sync that implies).

``profiler_annotations=True`` additionally wraps each span body in
``torch.profiler.record_function``, so the same span names appear inside a
``torch.profiler`` capture — off by default because the annotation has its
own overhead and most runs never profile (the reference's
``jax_annotations``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any

__all__ = ["Span", "Tracer"]


@dataclasses.dataclass
class Span:
    name: str
    t0_us: float  # offset from tracer epoch
    dur_us: float
    depth: int
    attrs: dict


def _annotation_ctx(name: str):
    import torch.profiler

    return torch.profiler.record_function(name)


class Tracer:
    def __init__(self, *, profiler_annotations: bool = False, clock=time.perf_counter):
        self._clock = clock
        self._epoch = clock()
        self.profiler_annotations = profiler_annotations
        self.spans: list[Span] = []
        self.events: list[dict] = []
        self.samples: list[dict] = []
        self._stack: list[str] = []

    def _now_us(self) -> float:
        return (self._clock() - self._epoch) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t0 = self._now_us()
        self._stack.append(name)
        ctx = _annotation_ctx(name) if self.profiler_annotations else contextlib.nullcontext()
        try:
            with ctx:
                yield self
        finally:
            depth = len(self._stack) - 1
            self._stack.pop()
            self.spans.append(
                Span(name=name, t0_us=t0, dur_us=self._now_us() - t0,
                     depth=depth, attrs=attrs)
            )

    def event(self, name: str, **attrs) -> None:
        self.events.append({"name": name, "ts_us": self._now_us(), "attrs": attrs})

    def sample(self, name: str, value: float) -> None:
        self.samples.append(
            {"name": name, "ts_us": self._now_us(), "value": float(value)}
        )

    # ---- export ----------------------------------------------------------
    def to_json(self) -> dict:
        """Timeline as plain data (spans sorted by start time)."""
        return {
            "clock": "perf_counter_us_since_tracer_start",
            "spans": [
                dataclasses.asdict(s)
                for s in sorted(self.spans, key=lambda s: s.t0_us)
            ],
            "events": list(self.events),
            "samples": list(self.samples),
        }

    def to_chrome(self) -> dict:
        """Chrome/Perfetto trace-event JSON (load in ``ui.perfetto.dev``)."""
        ev: list[dict] = []
        for s in sorted(self.spans, key=lambda s: s.t0_us):
            ev.append(
                {
                    "name": s.name, "ph": "X", "ts": s.t0_us, "dur": s.dur_us,
                    "pid": 0, "tid": 0, "args": s.attrs,
                }
            )
        for e in self.events:
            ev.append(
                {
                    "name": e["name"], "ph": "i", "ts": e["ts_us"], "s": "t",
                    "pid": 0, "tid": 0, "args": e["attrs"],
                }
            )
        for c in self.samples:
            ev.append(
                {
                    "name": c["name"], "ph": "C", "ts": c["ts_us"],
                    "pid": 0, "tid": 0, "args": {"value": c["value"]},
                }
            )
        # one global timestamp order: every (pid, tid) stream is monotonic,
        # which Perfetto's importer needs to thread the track correctly
        ev.sort(key=lambda e: e["ts"])
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def export_json(self, path: str, *, extra: dict | None = None) -> str:
        payload = dict(extra or {})
        payload["timeline"] = self.to_json()
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        return path

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")
        return path
