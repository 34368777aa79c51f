"""Port of the flight recorder (``repro.obs.flightrec`` / ``repro.obs.dump``):
the bounded event ring, postmortem bundles, the offline loader, and the
acceptance scenarios — an engineered refcount violation in a live
``BatchEngine`` and in a ``SlabArena`` must each write one bundle that
round-trips through ``repro_torch.obs.dump`` and names the offending slab.
Mirrors ``tests/obs/test_flightrec.py``, and adds that a bundle of either
package loads with the other package's loader (same schema name)."""
import json

import numpy as np
import pytest
import torch

from repro.obs import FlightRecorder as RFlightRecorder
from repro.obs import dump as ref_dump
from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.obs import FlightRecorder, ServingTimeline
from repro_torch.obs import dump as dump_mod
from repro_torch.obs import flightrec
from repro_torch.obs.flightrec import SCHEMA


def test_ring_is_bounded_and_keeps_the_most_recent_events():
    fr = FlightRecorder(capacity=4)
    for i in range(10):
        fr.note("tick", i=i)
    assert len(fr) == 4
    b = fr.bundle(reason="test")
    assert b["events_recorded"] == 10
    assert [e["attrs"]["i"] for e in b["events"]] == [6, 7, 8, 9]
    seqs = [e["seq"] for e in b["events"]]
    assert seqs == sorted(seqs)


def test_timeline_events_feed_the_ring_automatically():
    tl = ServingTimeline(flight_capacity=8)
    tl.event("admit", rid=3)
    tl.event("complete", rid=3)
    assert [e["name"] for e in tl.flight.events] == ["admit", "complete"]
    assert tl.flight.events[0]["attrs"]["rid"] == 3


def test_bundle_round_trips_through_loader(tmp_path):
    fr = FlightRecorder(capacity=8)
    fr.note("grow", slabs=2)
    err = AssertionError("refcounts drift from page tables: [5]")
    path = fr.dump(
        reason="refcount_mismatch", error=err,
        state={"invariant": {"offending_slabs": [5]}, "n_slabs": 8},
        metrics={"counters": {"serve.admitted": 1}},
        device_counters={"slab_append.waves": 3.0},
        directory=str(tmp_path),
    )
    assert path is not None and path.startswith(str(tmp_path))
    b = dump_mod.load_bundle(path)
    assert b["schema"] == SCHEMA == "repro.flightrec/1"
    assert b["reason"] == "refcount_mismatch"
    assert b["error"]["type"] == "AssertionError"
    assert b["state"]["invariant"]["offending_slabs"] == [5]
    assert b["device_counters"]["slab_append.waves"] == 3.0
    assert fr.last_bundle["reason"] == "refcount_mismatch"
    text = dump_mod.summarize(b)
    assert "refcount_mismatch" in text and "5" in text


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bundles_load_with_either_packages_loader(tmp_path, writer):
    """One schema: a port bundle loads with ``repro.obs.dump`` and a
    reference bundle with ``repro_torch.obs.dump``, and both render alike."""
    fr = FlightRecorder() if writer == "port" else RFlightRecorder()
    fr.note("admit", rid=1, slot=0)
    path = fr.dump(reason="cross_load", error=AssertionError("slab 7"),
                   state={"invariant": {"check": "liveness", "offending_slabs": [7]}},
                   device_counters={"paged_attend.lanes": 64.0}, directory=str(tmp_path))
    ours, theirs = dump_mod.load_bundle(path), ref_dump.load_bundle(path)
    assert ours == theirs and ours["state"]["invariant"]["offending_slabs"] == [7]
    assert dump_mod.summarize(ours) == ref_dump.summarize(theirs)
    assert flightrec.DIR_ENV == "REPRO_FLIGHTREC_DIR"


def test_dump_without_directory_keeps_bundle_in_process(monkeypatch):
    monkeypatch.delenv("REPRO_FLIGHTREC_DIR", raising=False)
    fr = FlightRecorder()
    assert fr.dump(reason="x", state={}) is None
    assert fr.last_bundle["reason"] == "x"


def test_dump_env_var_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FLIGHTREC_DIR", str(tmp_path / "artifacts"))
    path = FlightRecorder().dump(reason="env_target", state={})
    assert path is not None
    assert json.load(open(path))["reason"] == "env_target"


def test_dump_main_cli_smoke(tmp_path, capsys):
    fr = FlightRecorder()
    fr.note("admit", rid=0)
    path = fr.dump(reason="smoke", state={"n_slots": 2}, directory=str(tmp_path))
    assert dump_mod.main([path]) == 0
    out = capsys.readouterr().out
    assert "smoke" in out and "admit" in out
    bad = tmp_path / "missing.json"
    assert dump_mod.main([str(bad)]) == 1


def test_loader_rejects_non_bundles(tmp_path):
    p = tmp_path / "junk.json"
    p.write_text(json.dumps({"schema": "other/1"}))
    with pytest.raises(ValueError):
        dump_mod.load_bundle(str(p))


def test_jsonable_handles_numpy_and_torch_state():
    fr = FlightRecorder()
    fr.note("ev", ids=np.asarray([1, 2]), val=np.float32(0.5), t=torch.tensor([3, 4]))
    b = fr.bundle(reason="np", state={"refs": np.asarray([0, 1]), "dev": torch.tensor(2.5),
                                      "bf16": torch.ones(2, dtype=torch.bfloat16)})
    json.dumps(b)  # fully serialisable
    assert b["events"][0]["attrs"]["ids"] == [1, 2]
    assert b["events"][0]["attrs"]["t"] == [3, 4]
    assert b["state"]["refs"] == [0, 1] and b["state"]["dev"] == 2.5
    assert b["state"]["bf16"] == [1.0, 1.0]


# --------------------------------------------------------------------------
# acceptance: engineered invariant violations → named offending slab
# --------------------------------------------------------------------------

def _engine():
    from repro_torch.serving.engine import BatchEngine

    cfg = configs.reduced("qwen2.5-3b", cache_b0=4)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(cfg, gen)
    return BatchEngine(params, cfg, max_batch=2, instrument=True, device="cpu")


def test_refcount_violation_dumps_one_bundle_naming_the_slab(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FLIGHTREC_DIR", str(tmp_path))
    be = _engine()
    be.submit(list(range(1, 10)), 8)
    for _ in range(3):
        be.step()
    be.check_free_list()  # a clean engine passes and dumps nothing
    assert be.obs.flight.last_path is None
    claimed = [s for s in range(be.alloc.n_slabs) if not be.alloc.free[s]]
    assert claimed, "the request must hold at least one slab"
    be.alloc.refcount[claimed[0]] += 1  # engineered corruption
    with pytest.raises(AssertionError):
        be.check_free_list()
    assert len(list(tmp_path.glob("flightrec_*.json"))) == 1
    b = dump_mod.load_bundle(be.obs.flight.last_path)
    assert b["reason"] == "refcount_mismatch"
    inv = b["state"]["invariant"]
    assert inv["check"] == "refcount_conservation"
    assert inv["offending_slabs"] == [claimed[0]]
    assert inv["actual_refcount"][0] == inv["expected_refcount"][0] + 1
    assert b["state"]["scheduler"]["phase"].count("decode") == 1
    assert b["events"], "ring must hold the admit/step events"
    assert any(v > 0 for v in (b["device_counters"] or {}).values())
    assert str(claimed[0]) in dump_mod.summarize(b)


def test_free_bitmap_drift_is_dumped(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FLIGHTREC_DIR", str(tmp_path))
    be = _engine()
    be.run_all([[1, 2, 3]], 2)
    be.free_dev[0] = not bool(be.free_dev[0])
    with pytest.raises(AssertionError, match="drifted"):
        be.check_free_list()
    b = dump_mod.load_bundle(be.obs.flight.last_path)
    assert b["reason"] == "free_bitmap_drift"
    assert b["state"]["invariant"]["offending_slabs"] == [0]


def test_engine_step_failure_is_dumped_once(monkeypatch, tmp_path):
    """A failure inside step() writes one bundle; the same exception raised
    again is not dumped twice."""
    monkeypatch.setenv("REPRO_FLIGHTREC_DIR", str(tmp_path))
    be = _engine()
    be.submit([1, 2, 3], 4)
    boom = RuntimeError("injected")

    def explode():
        raise boom

    monkeypatch.setattr(be, "_step_inner", explode)
    with pytest.raises(RuntimeError):
        be.step()
    first = be.obs.flight.last_path
    assert first is not None
    assert dump_mod.load_bundle(first)["reason"] == "step_failure"
    with pytest.raises(RuntimeError):
        be.step()
    assert be.obs.flight.last_path == first
    assert len(list(tmp_path.glob("flightrec_*.json"))) == 1


def test_quota_failure_is_dumped(monkeypatch, tmp_path):
    from repro_torch.pool import QuotaExceeded
    from repro_torch.serving.engine import BatchEngine

    monkeypatch.setenv("REPRO_FLIGHTREC_DIR", str(tmp_path))
    cfg = configs.reduced("qwen2.5-3b", cache_b0=4)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    be = BatchEngine(params, cfg, max_batch=2, quota_slabs=1, device="cpu")
    be.submit(list(range(1, 12)), 4)  # 11 tokens: needs 2 slabs of 8
    with pytest.raises(QuotaExceeded):
        be.run()
    assert dump_mod.load_bundle(be.obs.flight.last_path)["reason"] == "quota_exceeded"
    assert len(list(tmp_path.glob("flightrec_*.json"))) == 1


def test_arena_invariant_violation_dumps_bundle(tmp_path, monkeypatch):
    from repro_torch.pool.arena import SlabArena

    monkeypatch.setenv("REPRO_FLIGHTREC_DIR", str(tmp_path))
    ar = SlabArena(3, 4, initial_slabs=2, instrument=True, device="cpu")
    ar.append(torch.arange(6, dtype=torch.float32).reshape(3, 2), np.ones((3, 2), bool))
    ar.check_invariants()  # a clean arena passes
    ar.alloc.refcount[0] += 1
    with pytest.raises(AssertionError):
        ar.check_invariants()
    assert len(list(tmp_path.glob("flightrec_*.json"))) == 1
    b = dump_mod.load_bundle(ar.flight.last_path)
    assert b["reason"] == "refcount_mismatch"
    assert b["state"]["invariant"]["offending_slabs"] == [0]
    assert b["device_counters"]["slab_append.waves"] == 1.0
    assert "refcount_mismatch" in dump_mod.summarize(b)
