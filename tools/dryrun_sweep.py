#!/usr/bin/env python3
"""The dry-run's cells, several processes at once: one
``python -m repro_torch.launch.dryrun --arch A --shape S --force`` a
(cell, mesh), each in a process of its own, at most ``--jobs`` at a time,
the longest first (``SHAPE_ORDER``): every cell of ``plan_cells()`` on
both meshes, and the ``--opt`` variants of qwen2.5-3b and dbrx-132b on
16×16.  Skipped cells write their JSON here, with the reference's reason.

    PYTHONPATH=src python tools/dryrun_sweep.py --results-dir DIR [--jobs N]

Each process's log goes to ``DIR/logs/``; one JSON line a finished
(cell, mesh), as each ends: its status, the process's exit code and wall
seconds.  Exits 1 if any cell errored.  No card needed; on a card's host
the fake tensors are labelled ``cuda``.  Compare two sweeps' folders with
``tools/dryrun_compare.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

OPT_ARCHS = ("qwen2.5-3b", "dbrx-132b")
# the train cells trace longest (5–11 min each on an 8-core CPU host, six
# at once), then prefill, decode and long context: started in that order,
# the last to end is not a long one started late
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def jobs() -> tuple[list, list]:
    """→ (the runnable (cell, multi_pod, opt) jobs in launch order, the
    skipped (cell, multi_pod) pairs)."""
    from repro_torch.launch.specs import plan_cells

    run, skipped = [], []
    for c in plan_cells():
        for mp in (True, False):
            (skipped if c.skip_reason else run).append((c, mp, False))
            if not mp and not c.skip_reason and c.arch in OPT_ARCHS:
                run.append((c, mp, True))
    return sorted(run, key=lambda j: SHAPE_ORDER.index(j[0].shape)), [(c, mp) for c, mp, _ in skipped]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results-dir", required=True)
    ap.add_argument("--jobs", type=int, default=os.cpu_count())
    args = ap.parse_args()

    import torch

    from repro_torch.launch import dryrun

    run, skipped = jobs()
    out = os.path.abspath(args.results_dir)
    logs = os.path.join(out, "logs")
    os.makedirs(logs, exist_ok=True)
    print(f"# torch {torch.__version__}, fakes {dryrun.fake_device()}, {len(run)} cells to trace, "
          f"{len(skipped)} skipped, {args.jobs} at once", flush=True)
    for c, mp in skipped:
        r = dryrun.run_cell(c, multi_pod=mp, force=True, results_dir=out)
        print(json.dumps({"cell": c.name, "mesh": r["mesh"], "status": r["status"],
                          "skip_reason": r["skip_reason"]}), flush=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def one(job):
        c, mp, opt = job
        stem = f"{c.arch}__{c.shape}__{'pod2x16x16' if mp else 'pod16x16'}{'__opt' if opt else ''}"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", c.arch, "--shape", c.shape,
               "--force", "--results-dir", out, "--multi-pod-only" if mp else "--single-pod-only",
               *(["--opt"] if opt else [])]
        t0 = time.monotonic()
        with open(os.path.join(logs, stem + ".log"), "w") as log:
            rc = subprocess.call(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        path = os.path.join(out, stem + ".json")
        r = json.load(open(path)) if os.path.exists(path) else {"status": "missing"}
        return {"cell": c.name, "mesh": "2x16x16" if mp else "16x16", "opt": opt, "status": r["status"],
                "rc": rc, "wall_s": round(time.monotonic() - t0, 1), "trace_s": r.get("trace_s"),
                "error": r.get("error", "")[:300]}

    failed = 0
    t0 = time.monotonic()
    with ThreadPoolExecutor(args.jobs) as ex:
        for done in as_completed([ex.submit(one, j) for j in run]):
            line = done.result()
            failed += line["status"] != "ok"
            print(json.dumps(line), flush=True)
    print(f"# {len(run)} traced, {len(run) - failed} ok, {failed} not, {len(skipped)} skipped, "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
