"""``tools/dryrun_compare.py`` on synthetic result folders of
``repro_torch.launch.dryrun``: equal folders exit 0; a folder differing in
any one compared field, or lacking a pair, exits 1 and names the field.
No dry-run is traced here."""
import copy
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
TOOL = os.path.join(HERE, "..", "tools", "dryrun_compare.py")

OK = {"cell": "qwen2.5-3b×decode_32k", "arch": "qwen2.5-3b", "shape": "decode_32k", "mesh": "16x16",
      "chips": 256, "fake_device": "cpu", "torch": "2.13.0+cpu", "status": "ok", "trace_s": 20.5,
      "memory": {"argument_bytes": 1200000000, "output_bytes": 40000000, "temp_bytes": 1352900,
                 "alias_bytes": 10000000, "hbm_used_bytes": 1231352900, "fits_80gb": True},
      "cost_flop_counter": {"flops": 3.1866e12},
      "cost_global": {"flops": 3.1866e12, "hbm_bytes": 3.19e15},
      "collectives": {"total_weighted": 9.0e7, "total_raw": 9.5e7, "all-gather": 8.0e7, "all-reduce": 1.0e7},
      "useful_flop_ratio": 0.87}
SKIPPED = {"cell": "qwen2.5-3b×long_500k", "arch": "qwen2.5-3b", "shape": "long_500k", "mesh": "2x16x16",
           "chips": 512, "torch": "2.13.0+cpu", "status": "skipped", "skip_reason": "full attention at 500k"}


def _folder(path, cells: dict) -> str:
    os.makedirs(path, exist_ok=True)
    for stem, r in cells.items():
        with open(os.path.join(path, stem + ".json"), "w") as f:
            json.dump(r, f)
    return str(path)


def _base() -> dict:
    return {"qwen2.5-3b__decode_32k__pod16x16": copy.deepcopy(OK),
            "qwen2.5-3b__long_500k__pod2x16x16": copy.deepcopy(SKIPPED)}


def _run(a: str, b: str):
    return subprocess.run([sys.executable, TOOL, a, b], capture_output=True, text=True, timeout=60)


def test_equal_folders_exit_zero(tmp_path):
    a = _folder(tmp_path / "a", _base())
    b = _base()
    for r in b.values():  # what traced it and how long it took are not compared
        r["torch"], r["fake_device"] = "2.11.0+cu128", "cuda"
    b["qwen2.5-3b__decode_32k__pod16x16"]["trace_s"] = 12.0
    out = _run(a, _folder(tmp_path / "b", b))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "2 pairs, 2 equal, 0 differ"
    assert "=  qwen2.5-3b__decode_32k__pod16x16: ok" in out.stdout


@pytest.mark.parametrize("field", ["hbm_used_bytes", "flops", "hbm_bytes", "collectives.all-reduce",
                                   "collectives.reduce-scatter", "useful_flop_ratio", "status"])
def test_a_differing_field_exits_one_and_is_named(tmp_path, field):
    a = _folder(tmp_path / "a", _base())
    b = _base()
    r = b["qwen2.5-3b__decode_32k__pod16x16"]
    if field == "hbm_used_bytes":
        r["memory"]["hbm_used_bytes"] += 1
    elif field in ("flops", "hbm_bytes"):
        r["cost_global"][field] *= 1.001
    elif field.startswith("collectives."):
        kind = field.split(".", 1)[1]
        r["collectives"][kind] = r["collectives"].get(kind, 0.0) + 512.0
    elif field == "useful_flop_ratio":
        r["useful_flop_ratio"] = 0.88
    else:
        b["qwen2.5-3b__decode_32k__pod16x16"] = dict(r, status="error", error="RuntimeError: x")
    out = _run(a, _folder(tmp_path / "b", b))
    assert out.returncode == 1, out.stdout + out.stderr
    line = next(x for x in out.stdout.splitlines() if "decode_32k" in x)
    assert line.startswith("!= ") and field in line, line
    assert out.stdout.strip().splitlines()[-1] == "2 pairs, 1 equal, 1 differ"


def test_a_missing_pair_exits_one(tmp_path):
    a = _folder(tmp_path / "a", _base())
    b = _base()
    del b["qwen2.5-3b__long_500k__pod2x16x16"]
    out = _run(a, _folder(tmp_path / "b", b))
    assert out.returncode == 1
    assert "!= qwen2.5-3b__long_500k__pod2x16x16: file 'present' vs 'missing'" in out.stdout
