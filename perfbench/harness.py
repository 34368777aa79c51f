"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

Everything that belongs to one piece is found by name, so a later change
adds a configuration, a traffic mix or a metric as new files and entries:

- ``BENCHMARK.json`` names the cell, its configuration and its traffic;
- ``configs/<config>.json`` holds the configuration as run (its deployment,
  guarantees and the limits of its correctness checks);
- ``traffic/<traffic>.json`` holds the mix's parameters and names the
  driver that runs it, ``drivers/<driver>.py``;
- ``metrics/<metric>.py`` reads one metric, end-to-end or per-layer, from
  the run's record and returns ``None`` where it finds nothing to read.

A driver sets up the system, measures the window, judges what the window
produced against a plain reference, and fills a ``Record``.  The harness
then reads the cell's metrics (its end-to-end metrics with ``--trace 0``,
its per-layer ones with ``--trace 1``), refuses to print a result if the
JAX package or JAX itself was loaded, and prints each compared number
beside its limit, last on standard error and last in the result line.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Record:
    """What one run measured; drivers set the attributes their cells have.
    A reader that reads an attribute its cell's driver never set raises
    ``AttributeError``: the run names it and is not correct."""

    def __init__(self):
        self.checks: list[tuple[str, float, float]] = []  # (name, value, limit): ok when value ≤ limit
        self.attempted = 0
        self.failed = 0
        self.trace = None  # tracing.DeviceTrace
        self.control = None
        self.memory_peak_bytes = 0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metrics: list[dict], cell: str) -> list[dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def cell_of(bench: dict, workload: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == workload:
            return c
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def resolve(bench: dict, workload: str, root: Path = ROOT) -> tuple[dict, dict, dict, object]:
    """The cell, its configuration, its traffic and its driver module."""
    cell = cell_of(bench, workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(root / conf["file"])
    config.setdefault("name", conf["name"])
    traffic = load_json(root / "perfbench" / "traffic" / f"{cell['traffic']}.json")
    driver = load_module(root / "perfbench" / "drivers" / f"{traffic['driver']}.py",
                         f"perfbench_driver_{traffic['driver']}")
    return cell, config, traffic, driver


def read_metrics(specs: list[dict], rec: Record, root: Path = ROOT) -> tuple[dict, list[str]]:
    """→ (the metrics read, the metrics whose reader asked the record for
    something the driver did not record).  A reader that returns ``None``
    found nothing to read (a kernel off the path): its metric is left out."""
    out, broken = {}, []
    for m in specs:
        reader = load_module(root / "perfbench" / "metrics" / f"{m['name']}.py",
                             "perfbench_metric_" + m["name"].replace(".", "_"))
        try:
            v = reader.read(rec)
        except AttributeError as e:
            print(f"metric {m['name']}: the run recorded no {e.name or e}", file=sys.stderr, flush=True)
            broken.append(m["name"])
            continue
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out, broken


def loaded_forbidden() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float, device: str = "cuda",
             bench: dict | None = None, config: dict | None = None, control: bool = False,
             root: Path = ROOT) -> tuple[dict, Record]:
    """One run → (the result line as a dict, the record).  ``config``
    replaces the cell's configuration file (the tests run small copies)."""
    bench = load_json(root / "BENCHMARK.json") if bench is None else bench
    cell, conf, tr, driver = resolve(bench, workload, root)
    conf = conf if config is None else config
    rec = Record()
    ctx = SimpleNamespace(cell=cell, config=conf, traffic=tr, seed=seed, seconds=seconds, trace=trace, device=device,
                  t_start=t_start, record=rec, control=control)
    driver.run(ctx)
    specs = _for_cell(bench["per_layer"] if trace else bench["end_to_end"], workload)
    metrics, broken = read_metrics(specs, rec, root)
    rec.checks.append(("metrics_unrecorded", len(broken), 0))
    correct = all(v <= lim for _, v, lim in rec.checks) and bool(rec.checks)
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": _device_name(device),
           "count": cell["chips"], "memory_peak_bytes": int(rec.memory_peak_bytes)}
    line = {"correct": correct, "attempted": int(rec.attempted), "failed": int(rec.failed), "metrics": metrics,
            "device": dev}
    if trace and rec.trace is not None and rec.trace.busy_s is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        line["breakdown"] = rec.trace.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rec.checks}
    return line, rec


def _device_name(device: str) -> str:
    if device != "cuda":
        return device
    import torch

    return torch.cuda.get_device_name(0)


def emit(line: dict) -> int:
    """Print the checks on standard error and the result line last on
    standard output → the exit code (nonzero, and no result, when a
    forbidden package was loaded)."""
    bad = loaded_forbidden()
    if bad:
        print(f"refused: the run loaded {', '.join(bad)}", file=sys.stderr, flush=True)
        return 3
    for name, c in line["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
