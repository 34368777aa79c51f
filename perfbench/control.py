"""The correctness control, run apart from the benchmark's own runs.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --seconds 20

For each seed, one process runs the cell as the benchmark does (set-up, a
window of ``--seconds`` at the cell's own load), then puts the control in
the program's place: the plain reference computed in the nearest precision
below the configuration's (bf16 for an f32 array), judged by the cell's own comparison against
the limits in ``configs/``.  Prints one JSON line a seed: ``correct`` and
``checks`` are the control's (``correct`` has to come out false), and
``program`` holds the program's reading of the same run.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import gc

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("no result: the control runs on a CUDA card", file=sys.stderr)
        return 2
    t_start = T_START  # the first seed pays the process's start
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line, rec = harness.run_cell(args.workload, seed, args.seconds, False, t_start=t_start, control=True)
        t_start = time.perf_counter()
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": line["correct"],
                          "checks": line["checks"], "program": rec.control, "metrics": line["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del rec, line
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
