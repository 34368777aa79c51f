"""Each cell end to end on a CUDA card, through the benchmark's command, at
a short window (skips without a card)."""
import json
import subprocess
import sys

import pytest

from perfbench import harness

CELLS = [c["name"] for c in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, card):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed", "2147483659",
                          "--seconds", "5", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2


def test_the_command_refuses_without_a_card():
    """No CUDA card here: no result line, a nonzero exit (runs only where
    there is none)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
