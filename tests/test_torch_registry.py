"""Port of the metrics registry: the counter, gauge, histogram and lazy-drain
cases of ``tests/obs/test_registry.py`` that ``FreezeStats`` relies on.
Values are exact integers and floats set by the test: compared with ==."""
import json

import pytest
import torch

from repro_torch.obs import MetricsRegistry
from repro_torch.obs.registry import RESERVOIR_CAP


def test_counter_labels_are_series():
    reg = MetricsRegistry()
    c = reg.counter("serve.host_syncs")
    c.inc(site="stop_drain")
    c.inc(site="stop_drain")
    c.inc(3, site="stream_drain")
    assert c.value(site="stop_drain") == 2
    assert c.value(site="stream_drain") == 3
    assert c.value(site="never") == 0
    assert c.total() == 5
    snap = reg.snapshot()["counters"]
    assert snap["serve.host_syncs{site=stop_drain}"] == 2


def test_counter_lazy_device_scalars_drain_once(monkeypatch):
    """add_lazy keeps scalars on the device; reading drains all of them with
    one transfer (one ``Tensor.item``)."""
    reg = MetricsRegistry()
    c = reg.counter("runtime.elements_frozen")
    calls = []
    real = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", lambda self: calls.append(1) or real(self))
    c.add_lazy(torch.tensor(10, dtype=torch.int32))
    c.add_lazy(torch.tensor(20, dtype=torch.int32))
    c.add_lazy(torch.tensor(12, dtype=torch.int32))
    assert calls == [], "recording must not touch the host"
    assert c.total() == 42
    assert len(calls) == 1, "three pending scalars must drain in one transfer"
    assert c.total() == 42
    assert len(calls) == 1


def test_gauge_tracks_high_water_mark():
    reg = MetricsRegistry()
    g = reg.gauge("pool.live_tokens")
    for v in (3, 11, 7, 0):
        g.set(v)
    assert g.value() == 0 and g.hwm() == 11
    assert reg.snapshot()["gauges"]["pool.live_tokens"] == {"value": 0, "hwm": 11}


def test_gauge_fn_reads_live_callback():
    reg = MetricsRegistry()
    state = {"syncs": 0}
    reg.gauge_fn("planner.host_syncs", lambda: state["syncs"])
    state["syncs"] = 7
    assert reg.snapshot()["gauges"]["planner.host_syncs"]["value"] == 7


def test_histogram_quantiles_and_series():
    reg = MetricsRegistry()
    h = reg.histogram("runtime.freeze_ms")
    for i, v in enumerate([10.0, 20.0, 30.0, 40.0]):
        h.observe(v, rid=i % 2)
    assert h.count() == 4
    assert h.values(rid=0) == [10.0, 30.0]
    assert h.quantile(0.5) == pytest.approx(25.0)
    snap = reg.snapshot()["histograms"]["runtime.freeze_ms"]
    assert snap["count"] == 4 and snap["max"] == 40.0
    assert snap["series"]["runtime.freeze_ms{rid=1}"]["count"] == 2
    with pytest.raises(ValueError):
        h.quantile(0.5, rid=99)


def test_kind_conflict_and_get_or_create():
    reg = MetricsRegistry()
    assert reg.counter("a") is reg.counter("a")
    with pytest.raises(TypeError):
        reg.gauge("a")
    with pytest.raises(TypeError):
        reg.gauge_fn("a", lambda: 0)
    assert reg.names() == ["a"]


def test_snapshot_is_json_safe_after_lazy_adds():
    reg = MetricsRegistry()
    reg.counter("c").inc(2)
    reg.counter("c").add_lazy(torch.tensor(3, dtype=torch.int32))
    reg.gauge("g").set(1.5)
    reg.histogram("h").observe(3.0)
    snap = reg.snapshot()
    json.dumps(snap)
    assert snap["counters"]["c"] == 5


def test_histogram_memory_is_bounded_past_the_cap():
    h = MetricsRegistry().histogram("bounded")
    n = RESERVOIR_CAP + 500
    for i in range(n):
        h.observe(float(i))
    assert len(h.values()) == RESERVOIR_CAP
    assert h.count() == n and h.sum() == float(n * (n - 1) // 2)


def test_registry_matches_reference_on_one_sequence():
    """The same recording sequence gives the same snapshot in both packages."""
    import jax.numpy as jnp
    from repro.obs import MetricsRegistry as RefRegistry

    ours, ref = MetricsRegistry(), RefRegistry()
    for reg, scalar in ((ours, lambda v: torch.tensor(v, dtype=torch.int32)),
                        (ref, lambda v: jnp.int32(v))):
        reg.counter("runtime.appends").inc()
        reg.counter("runtime.appends").inc(4)
        reg.counter("runtime.elements_frozen").add_lazy(scalar(17))
        reg.counter("runtime.elements_frozen").add_lazy(scalar(5))
        reg.gauge("runtime.last_freeze_s").set(0.25)
        for v in range(RESERVOIR_CAP + 50):
            reg.histogram("runtime.freeze_ms").observe(float(v % 97))
    assert ours.snapshot() == ref.snapshot()
