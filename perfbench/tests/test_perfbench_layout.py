"""BENCHMARK.json against the files it names, and the harness finding new
pieces by name."""
import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _cells_of(metric: dict) -> list[str]:
    return metric.get("workloads", [c["name"] for c in BENCH["workloads"]])


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_each_cell_names_what_exists(cell):
    c = harness.cell_of(BENCH, cell)
    assert len(c["why"]) <= 200 and c["chips"] == 1
    conf = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    assert (ROOT / conf["file"]).is_file()
    traffic = harness.load_json(ROOT / "perfbench/traffic" / f"{c['traffic']}.json")
    assert (ROOT / "perfbench/drivers" / f"{traffic['driver']}.py").is_file()
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in _cells_of(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert [m for m in BENCH["per_layer"] if cell in _cells_of(m)]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_each_metric_has_a_reader(metric):
    m = next(x for x in BENCH["end_to_end"] + BENCH["per_layer"] if x["name"] == metric)
    assert (ROOT / "perfbench/metrics" / f"{metric}.py").is_file()
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(_cells_of(m)) <= cells
    if "moves" in m:  # a per-layer metric: its end-to-end metric is reported wherever it is
        e2e = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(_cells_of(m)) <= set(_cells_of(e2e))
        assert 0 < len(m["layer"]) <= 200
    else:
        assert 0.01 <= m["bound"] <= 0.25


def test_configs_keep_their_published_widths():
    for conf in BENCH["configs"]:
        data = harness.load_json(ROOT / conf["file"])
        assert data["reduced"] == conf["reduced"] == []


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in (ROOT / "perfbench").rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = _imports(ROOT / path)
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    if "/reference/" in path or "/arith/" in path:
        assert "repro_torch" not in tops, f"{path}: the yardstick imports the program"


def test_new_cell_and_metric_are_found_without_an_edit(tmp_path):
    """A later change adds a configuration file, a metric reader and their
    entries; the harness finds both by name and runs the new cell."""
    from perfbench.tests import small

    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
    bench = json.loads(json.dumps(BENCH))
    conf = dict(small.sec6(), name="ggarray-sec6-4", nblocks=4)
    (tmp_path / "perfbench/configs/ggarray-sec6-4.json").write_text(json.dumps(conf))
    (tmp_path / "perfbench/metrics/jobs.gg4.py").write_text("def read(rec):\n    return rec.jobs\n")
    bench["configs"].append({"name": "ggarray-sec6-4", "source": "tests", "reduced": [], "why": "four LFVectors",
                             "file": "perfbench/configs/ggarray-sec6-4.json"})
    bench["workloads"].append({"name": "gg-sec6-4", "config": "ggarray-sec6-4", "traffic": "sec6-jobs", "chips": 1,
                               "why": "four LFVectors"})
    bench["per_layer"].append({"name": "jobs.gg4", "unit": "jobs", "better": "higher", "source": "program_counter",
                               "layer": "runtime phases", "moves": "twophase_job_s", "workloads": ["gg-sec6-4"]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("gg-sec6-4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, found, _, driver = harness.resolve(bench, "gg-sec6-4", tmp_path)
    assert found["nblocks"] == 4 and driver.run
    line, rec = harness.run_cell("gg-sec6-4", 5, 0.5, False, t_start=0.0, device="cpu", root=tmp_path)
    assert line["correct"], line["checks"]
    assert "twophase_job_s" in line["metrics"] and rec.jobs >= 1
    per_layer = [m for m in bench["per_layer"] if "gg-sec6-4" in m["workloads"]]  # read in a traced run
    assert harness.read_metrics(per_layer, rec, tmp_path)[0]["jobs.gg4"] == {"value": float(rec.jobs), "unit": "jobs"}


def test_a_metric_the_run_did_not_record_makes_it_incorrect(tmp_path, monkeypatch):
    """A reader that asks the record for a field its driver never set (a
    field renamed in the driver, say) names it, and the run is not
    correct; a reader that finds nothing to read leaves its metric out."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
    (tmp_path / "perfbench/metrics/renamed.gg.py").write_text("def read(rec):\n    return rec.no_such_field\n")
    (tmp_path / "perfbench/metrics/silent.gg.py").write_text("def read(rec):\n    return None\n")
    rec = harness.Record()
    specs = [{"name": "renamed.gg", "unit": "ms"}, {"name": "silent.gg", "unit": "ms"}]
    assert harness.read_metrics(specs, rec, tmp_path) == ({}, ["renamed.gg"])

    from perfbench.tests import small

    bench = json.loads(json.dumps(BENCH))
    bench["end_to_end"].append({"name": "renamed.gg", "unit": "ms", "better": "lower", "bound": 0.05,
                                "source": "host_clock", "workloads": ["gg-sec6-512"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    line, _ = harness.run_cell("gg-sec6-512", 5, 0.5, False, t_start=0.0, device="cpu", bench=bench,
                               config=small.sec6(), root=tmp_path)
    assert not line["correct"] and line["checks"]["metrics_unrecorded"]["value"] == 1
