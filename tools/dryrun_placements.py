#!/usr/bin/env python3
"""Every ``DTensor`` op of one dry-run cell, with the placements and global
shapes of its inputs and outputs, as DTensor's sharding rules chose them,
and the diff of two such records: where two torch versions' rules choose
differently.

    PYTHONPATH=src python tools/dryrun_placements.py record ARCH SHAPE OUT.json [--full] [--opt] [--multi-pod]
    python tools/dryrun_placements.py diff A.json B.json

``record`` runs the cell's step on the fake 16x16 mesh (2x16x16 with
``--multi-pod``) as
``launch.dryrun`` does, cut to one period of layers (and one encoder
layer) unless ``--full``; each entry is (op, inputs, outputs, the autograd
node running it in the backward, else null).  ``diff`` prints rank 0's
peak and op count of each record and the first differing stretches.  Run
``record`` under each torch (this sandbox's, the card's) and ``diff`` the
two files.  ``recorder()`` is the record's dispatch mode, for a test that
reads the placements an op received.
"""
from __future__ import annotations

import argparse
import dataclasses
import difflib
import json


def recorder():
    """→ (a ``TorchDispatchMode`` that records every op receiving a
    ``DTensor``, the list it appends to): each entry is (op, inputs,
    outputs, the autograd node running it in the backward, else null), an
    input or output a [global shape, [placement, ...]] pair ("plain" for a
    plain tensor's placements).  Enter it above ``count_fn``'s mode, so
    that it sees each op at its ``DTensor`` level."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    def sig(x):
        if isinstance(x, DTensor):
            return [list(x.shape), [repr(p) for p in x.placements]]
        if isinstance(x, torch.Tensor):
            return [list(x.shape), "plain"]
        if isinstance(x, (list, tuple)):
            return [sig(y) for y in x if isinstance(y, (torch.Tensor, list, tuple))]
        return None

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            if any(issubclass(t, DTensor) for t in types):
                node = torch._C._current_autograd_node()
                ops.append([str(func), sig(list(args)), sig(res), None if node is None else node.name()])
            return res

    return Record(), ops


def record(arch: str, shape: str, out: str, full: bool, opt: bool, multi_pod: bool = False) -> None:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import configs
    from repro_torch.analysis import flops
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh

    if not full:
        whole = configs.get

        def one_period(name):
            cfg = whole(name)
            return dataclasses.replace(cfg, n_layers=len(cfg.layout), n_enc_layers=min(cfg.n_enc_layers, 1))

        configs.get = one_period

    mode, ops = recorder()
    with dryrun.fake_world(512 if multi_pod else 256):
        dev = dryrun.fake_device()
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        with FakeTensorMode(allow_non_fake_inputs=True), activation_mesh(mesh):
            step, args, _ = specs.build_cell(specs.Cell(arch, shape), mesh, device=dev, opt=opt)

            def run(*a):
                with mode:  # above count_fn's mode: each op at its DTensor level
                    return step(*a)

            got = flops.count_fn(run, *args)
    with open(out, "w") as f:
        json.dump({"cell": f"{arch}×{shape}", "opt": opt, "full": full, "torch": torch.__version__,
                   "peak_bytes": got["peak_bytes"], "ops": ops}, f)
    print(torch.__version__, "peak", got["peak_bytes"], "ops", len(ops), flush=True)


def diff(a_path: str, b_path: str, stretches: int = 5) -> None:
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    A, B = ([json.dumps(o) for o in r["ops"]] for r in (a, b))
    blocks = [c for c in difflib.SequenceMatcher(None, A, B, autojunk=False).get_opcodes() if c[0] != "equal"]
    for r in (a, b):
        print(r["torch"], r["cell"], "peak", r["peak_bytes"], "ops", len(r["ops"]))
    print("differing stretches:", len(blocks))
    for _, i1, i2, j1, j2 in blocks[:stretches]:
        for x in A[i1:i2][:3]:
            print("  ", a["torch"], x)
        for x in B[j1:j2][:3]:
            print("  ", b["torch"], x)


def main() -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("record")
    r.add_argument("arch")
    r.add_argument("shape")
    r.add_argument("out")
    r.add_argument("--full", action="store_true", help="the config's own depth")
    r.add_argument("--opt", action="store_true", help="the hill-climb variant")
    r.add_argument("--multi-pod", action="store_true", help="the 2x16x16 mesh")
    d = sub.add_parser("diff")
    d.add_argument("a")
    d.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "record":
        record(args.arch, args.shape, args.out, args.full, args.opt, args.multi_pod)
    else:
        diff(args.a, args.b)


if __name__ == "__main__":
    main()
