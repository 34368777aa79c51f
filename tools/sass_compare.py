#!/usr/bin/env python3
"""Compare the machine code (SASS) of the kernels in two builds of one of
the port's CUDA libraries, kernel by kernel: identical, or how many
instructions differ.  Needs the CUDA toolkit's ``cuobjdump`` and
``cu++filt``, so it runs on the machine with the card.

    python3 tools/sass_compare.py OLD.so NEW.so [--new-arg false]

``--new-arg V``: some of NEW's kernels carry one more template argument,
last, than OLD's; a NEW kernel whose last argument is V is held against the
OLD kernel without it, one of the same name against its namesake, and the
rest are listed as new.
"""
import argparse
import os
import re
import subprocess
from pathlib import Path


def _tool(name: str) -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / name).is_file():
            return str(Path(root) / "bin" / name)
    return name


def _without_params(sig: str) -> str:
    """A demangled signature less its parameter list, the last top-level
    parenthesised group (template arguments may hold parentheses too)."""
    depth = 0
    for i in range(len(sig) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(sig[i], 0)
        if depth == 0 and sig[i] == "(":
            return sig[:i]
    return sig


def kernels(lib: str) -> dict[str, list[str]]:
    """{demangled kernel name without its parameters: its SASS instructions,
    addresses and encodings dropped}."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            demangled = subprocess.run([_tool("cu++filt"), m.group(1)], capture_output=True, text=True,
                                       check=True).stdout.strip()
            name = _without_params(demangled).replace("(bool)0", "false").replace("(bool)1", "true")
            out[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name is not None and ins:
            out[name].append(ins.group(1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--new-arg", help="NEW's extra last template argument held against OLD")
    args = ap.parse_args()
    old, new = kernels(args.old), kernels(args.new)
    suffix = f", {args.new_arg}>" if args.new_arg else None
    matched = set()
    for name, body in sorted(new.items()):
        key = name[: -len(suffix)] + ">" if suffix and name.endswith(suffix) else name
        if key not in old:
            print(f"new        {len(body):6d} instructions  {name}")
            continue
        matched.add(key)
        ref = old[key]
        diff = sum(a != b for a, b in zip(ref, body)) + abs(len(ref) - len(body))
        verdict = "identical" if diff == 0 else f"{diff} differ"
        print(f"{verdict:10s} {len(ref):6d} -> {len(body):6d} instructions  {name}")
    for name in sorted(set(old) - matched):
        print(f"gone       {len(old[name]):6d} instructions  {name}")


if __name__ == "__main__":
    main()
