"""Load + pretty-print flight-recorder postmortem bundles — port of
``repro/obs/dump.py``.

``python -m repro_torch.obs.dump bundle.json`` renders a bundle written by
:class:`repro_torch.obs.flightrec.FlightRecorder` — the violation, the structured
state snapshot (offending slabs, scheduler queue, refcount/free summaries),
the hottest device counters, and the tail of the event ring — so an arena
invariant violation from a CI run is diagnosable offline from the uploaded
artifact alone.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import flightrec

__all__ = ["load_bundle", "summarize", "main"]


def load_bundle(path: str) -> dict:
    """Read + validate a postmortem bundle (schema-checked round-trip)."""
    with open(path) as f:
        b = json.load(f)
    schema = b.get("schema")
    if schema != flightrec.SCHEMA:
        raise ValueError(
            f"{path}: schema {schema!r} is not {flightrec.SCHEMA!r}"
        )
    for key in ("reason", "events", "state"):
        if key not in b:
            raise ValueError(f"{path}: bundle is missing {key!r}")
    return b


def _fmt_counters(counters: dict, limit: int = 12) -> list[str]:
    nonzero = {k: v for k, v in counters.items() if v}
    top = sorted(nonzero.items(), key=lambda kv: -abs(kv[1]))[:limit]
    return [f"    {name:<28} {value:g}" for name, value in top]


def summarize(bundle: dict, *, tail: int = 20) -> str:
    """Human-readable rendering of one bundle."""
    lines = [f"flight recorder bundle — reason: {bundle['reason']}"]
    err = bundle.get("error")
    if err:
        lines.append(f"  error: {err['type']}: {err['message']}")
    state = bundle.get("state") or {}
    inv = state.get("invariant")
    if inv:
        lines.append("  invariant:")
        for k, v in inv.items():
            lines.append(f"    {k}: {v}")
    sched = state.get("scheduler")
    if sched:
        lines.append(
            "  scheduler: tick {tick}, {npending} pending, slots {slots}".format(
                tick=sched.get("tick"),
                npending=len(sched.get("pending", [])),
                slots=sched.get("phase"),
            )
        )
    alloc = state.get("allocator")
    if alloc:
        lines.append(
            "  allocator: {n_slabs} slabs, {free} free, refcount sum "
            "{ref_sum}".format(
                n_slabs=alloc.get("n_slabs"),
                free=alloc.get("free_slabs"),
                ref_sum=alloc.get("refcount_sum"),
            )
        )
    pages = state.get("page_tables")
    if pages:
        lines.append(f"  page tables: {len(pages)} live slots")
    prefix = state.get("prefix")
    if prefix:
        lines.append(f"  prefix cache: {prefix}")
    dev = bundle.get("device_counters") or {}
    rows = _fmt_counters(dev)
    if rows:
        lines.append("  device counters (nonzero):")
        lines.extend(rows)
    events = bundle.get("events") or []
    lines.append(
        f"  events: {len(events)} in ring "
        f"({bundle.get('events_recorded', len(events))} recorded)"
    )
    for ev in events[-tail:]:
        attrs = ev.get("attrs")
        suffix = f" {attrs}" if attrs else ""
        lines.append(f"    [{ev['seq']:>6}] {ev['name']}{suffix}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bundle", help="path to a flightrec_*.json bundle")
    ap.add_argument(
        "--tail", type=int, default=20, help="event-ring tail length to show"
    )
    args = ap.parse_args(argv)
    try:
        bundle = load_bundle(args.bundle)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"repro_torch.obs.dump: {e}", file=sys.stderr)
        return 1
    print(summarize(bundle, tail=args.tail))
    return 0


if __name__ == "__main__":
    sys.exit(main())
