"""Port of the serving timeline (``repro.obs.trace`` / ``timeline``): the
same spans, events and gauge samples on the same clock give the same JSON
and Chrome exports and the same registry snapshot as the reference."""
import json

import pytest

from repro.obs import trace as rtrace
from repro.obs.timeline import ServingTimeline as RTimeline
from repro_torch.obs import trace
from repro_torch.obs.timeline import ServingTimeline


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _drive(tl):
    tl.event("submit", rid=0, prompt_len=5)
    with tl.span("prefill_chunk", rid=0, t0=0, width=8):
        tl.gauge_sample("pool.live_tokens", 5)
        with tl.span("inner"):
            tl.event("first_token", rid=0)
    for step in range(3):
        with tl.span("decode_step", step=step, active=1):
            tl.gauge_sample("pool.utilization", 0.5 + step / 10)
    tl.registry.counter("serve.host_syncs").inc(site="stream_drain")
    tl.registry.histogram("serve.ttft_ms").observe(12.5, rid=0)


@pytest.mark.parametrize("fmt", ["json", "chrome", "snapshot"])
def test_timeline_matches_reference(fmt, tmp_path):
    ours, theirs = ServingTimeline(), RTimeline()
    ours.tracer = trace.Tracer(clock=Clock())
    theirs.tracer = rtrace.Tracer(clock=Clock())
    _drive(ours)
    _drive(theirs)
    if fmt == "json":
        assert ours.tracer.to_json() == theirs.tracer.to_json()
        path = ours.export_json(str(tmp_path / "t.json"))
        assert json.load(open(path))["timeline"] == theirs.tracer.to_json()
    elif fmt == "chrome":
        assert ours.tracer.to_chrome() == theirs.tracer.to_chrome()
        path = ours.export_chrome(str(tmp_path / "c.json"))
        assert json.load(open(path)) == json.loads(json.dumps(theirs.tracer.to_chrome()))
    else:
        assert ours.snapshot() == theirs.snapshot()


def test_profiler_annotations_wrap_spans():
    tl = ServingTimeline(profiler_annotations=True)
    with tl.span("decode_step"):
        pass
    assert [s.name for s in tl.tracer.spans] == ["decode_step"]
