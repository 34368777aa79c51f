"""Flight recorder — bounded event ring + postmortem bundles (DESIGN.md §9.y)
— port of ``repro/obs/flightrec.py``.

An arena invariant violation used to be a bare ``AssertionError`` with the
interesting state (scheduler queue, page tables, refcounts, free bitmap)
already torn down by the time anyone looks.  The flight recorder keeps a
bounded ring of recent timeline events — ``ServingTimeline.event`` feeds it
automatically, so every admit/complete/grow/evict/cow the engine already
records is in the ring at zero extra call sites — and, on failure, freezes
everything into a JSON **postmortem bundle**:

* the event ring (most recent ``capacity`` events, in order),
* a full engine-state snapshot supplied by the failing component
  (scheduler queue + reservations, page tables, slab refcounts, prefix-trie
  shape, free-bitmap summary — see ``BatchEngine._flightrec_state``),
* the registry snapshot (THE lazy-counter drain point, so pending device
  scalars and the device counter plane are materialized into the bundle),
* the violation itself (exception type/message plus structured details like
  the offending slab ids).

Bundles are written to ``REPRO_FLIGHTREC_DIR`` when set (the pytest/CI hook
points it at an artifact dir) and always kept on ``last_bundle`` for
in-process inspection.  ``python -m repro_torch.obs.dump bundle.json``
pretty-prints one offline (``repro_torch/obs/dump.py``).  The schema name
and the directory variable are the reference's, so a bundle written by
either package loads with either loader.

Recording is host-only and O(1) per event; nothing here touches the device
until a bundle is actually built (failure path), so the zero-sync contract
of the hot path is untouched.
"""
from __future__ import annotations

import collections
import json
import os
import time

import torch

__all__ = ["FlightRecorder", "SCHEMA", "DIR_ENV"]

SCHEMA = "repro.flightrec/1"
DIR_ENV = "REPRO_FLIGHTREC_DIR"


def _jsonable(x):
    """Best-effort conversion of event/state values to JSON-safe types."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        return [_jsonable(v) for v in x]
    if isinstance(x, torch.Tensor):  # reads the device: failure path only
        return _jsonable(x.detach().cpu().tolist())
    tolist = getattr(x, "tolist", None)  # numpy scalars/arrays
    if callable(tolist):
        return _jsonable(tolist())
    item = getattr(x, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return repr(x)


class FlightRecorder:
    """Bounded ring of recent events; builds and writes postmortem bundles."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self.last_bundle: dict | None = None
        self.last_path: str | None = None
        self._seq = 0
        self._epoch = time.perf_counter()

    # ---- recording (hot path: O(1) host work) ----------------------------
    def note(self, name: str, **attrs) -> None:
        self._seq += 1
        ev = {
            "seq": self._seq,
            "t_us": (time.perf_counter() - self._epoch) * 1e6,
            "name": name,
        }
        if attrs:
            ev["attrs"] = {k: _jsonable(v) for k, v in attrs.items()}
        self.events.append(ev)

    def __len__(self) -> int:
        return len(self.events)

    # ---- failure path ----------------------------------------------------
    def bundle(
        self,
        *,
        reason: str,
        error: BaseException | None = None,
        state: dict | None = None,
        metrics: dict | None = None,
        device_counters: dict | None = None,
    ) -> dict:
        """Freeze the ring + supplied state into a postmortem bundle dict."""
        err = None
        if error is not None:
            err = {"type": type(error).__name__, "message": str(error)}
        b = {
            "schema": SCHEMA,
            "reason": reason,
            "error": err,
            "events_recorded": self._seq,
            "events": [dict(e) for e in self.events],
            "state": _jsonable(state or {}),
            "metrics": _jsonable(metrics),
            "device_counters": _jsonable(device_counters),
        }
        self.last_bundle = b
        return b

    def dump(
        self,
        *,
        reason: str,
        error: BaseException | None = None,
        state: dict | None = None,
        metrics: dict | None = None,
        device_counters: dict | None = None,
        directory: str | None = None,
    ) -> str | None:
        """Build a bundle and write it under ``directory`` (default: the
        ``REPRO_FLIGHTREC_DIR`` env var).  Returns the written path, or
        ``None`` when no directory is configured (the bundle is still kept
        on ``last_bundle``).  Never raises — the recorder must not mask the
        original failure."""
        b = self.bundle(
            reason=reason,
            error=error,
            state=state,
            metrics=metrics,
            device_counters=device_counters,
        )
        directory = directory or os.environ.get(DIR_ENV)
        if not directory:
            return None
        try:
            os.makedirs(directory, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
            path = os.path.join(
                directory, f"flightrec_{safe}_{os.getpid()}_{self._seq}.json"
            )
            with open(path, "w") as f:
                json.dump(b, f, indent=2)
                f.write("\n")
        except OSError:
            return None
        self.last_path = path
        return path
