#!/usr/bin/env python3
"""Two result folders of ``repro_torch.launch.dryrun`` (two torch versions,
or two trees), compared field by field for each (cell, mesh, variant):
status, rank 0's ``hbm_used_bytes``, ``cost_global``'s FLOPs and
``hbm_bytes``, the collective bytes by kind and ``useful_flop_ratio`` (a
skipped cell: its status and reason).

    python tools/dryrun_compare.py A_DIR B_DIR

One line a pair found in either folder (``=`` equal, ``!=`` not, with the
fields that differ and both values; a pair that one folder lacks differs),
then the count.  Exits 1 on any difference, else 0.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def fields(r: dict) -> dict:
    """The figures compared, by name, of one cell's JSON."""
    if r.get("status") != "ok":
        return {"status": r.get("status"), "skip_reason": r.get("skip_reason"), "error": r.get("error")}
    coll = {k: v for k, v in r["collectives"].items() if k not in ("total_weighted", "total_raw")}
    return {"status": "ok", "hbm_used_bytes": r["memory"]["hbm_used_bytes"],
            "flops": r["cost_global"]["flops"], "hbm_bytes": r["cost_global"]["hbm_bytes"],
            **{f"collectives.{k}": v for k, v in sorted(coll.items())},
            "useful_flop_ratio": r["useful_flop_ratio"]}


def load(folder: str) -> dict:
    """Result file stem (``arch__shape__mesh[__opt]``) → that cell's JSON."""
    out = {}
    for path in glob.glob(os.path.join(folder, "*.json")):
        with open(path) as f:
            out[os.path.basename(path)[:-len(".json")]] = json.load(f)
    return out


def compare(a: dict, b: dict) -> list[tuple[str, dict]]:
    """Per pair (sorted): its stem and the fields that differ, name →
    (A's value, B's value); an empty dict where they agree."""
    rows = []
    for stem in sorted(set(a) | set(b)):
        if stem not in a or stem not in b:
            rows.append((stem, {"file": ("present" if stem in a else "missing",
                                         "present" if stem in b else "missing")}))
            continue
        fa, fb = fields(a[stem]), fields(b[stem])
        rows.append((stem, {k: (fa.get(k), fb.get(k)) for k in sorted(set(fa) | set(fb))
                            if fa.get(k) != fb.get(k)}))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("a", help="a results folder of launch.dryrun")
    ap.add_argument("b", help="another")
    args = ap.parse_args()
    a, b = load(args.a), load(args.b)
    va = {r.get("torch") for r in a.values()}
    vb = {r.get("torch") for r in b.values()}
    print(f"# A {args.a} (torch {sorted(map(str, va))}), B {args.b} (torch {sorted(map(str, vb))})")
    rows = compare(a, b)
    for stem, diff in rows:
        status = fields(a[stem])["status"] if stem in a else fields(b[stem])["status"]
        if not diff:
            print(f"=  {stem}: {status}")
        else:
            print(f"!= {stem}: " + "; ".join(f"{k} {x!r} vs {y!r}" for k, (x, y) in diff.items()))
    bad = sum(bool(d) for _, d in rows)
    print(f"{len(rows)} pairs, {len(rows) - bad} equal, {bad} differ")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
