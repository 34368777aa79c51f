#!/usr/bin/env python3
"""The port's step counter against the reference's on reduced cells: the
FLOPs and modelled HBM bytes of ``repro_torch.analysis.flops.count_fn``
over the port's train, prefill and decode steps of reduced qwen2.5-3b, and
of ``repro.analysis.flops.count_fn`` over the reference's same steps, with
their ratios.

    PYTHONPATH=src python tools/count_vs_reference.py   # CPU only, a minute
    PYTHONPATH=src python tools/count_vs_reference.py --mesh 2x4 [--opt] [--src SRC]

A jaxpr equation and an aten op are not the same unit of traffic (XLA's
jaxpr keeps a fused ``dot_general`` where PyTorch dispatches a reshape, a
copy and an ``mm``), so the bytes ratio is a record, not a check; the
FLOPs are held by ``tests/test_torch_dryrun.py`` (the train step less the
reference's recomputed scores, which the port keeps).

``--mesh DxM`` runs each package's own ``build_cell`` (``--opt``: the
hill-climb variants) on a D×M ('data', 'model') mesh, its config and
shape swapped for the reduced ones: the port's on PyTorch's fake process
group of D·M ranks, as ``launch.dryrun`` runs a cell, the reference's
compiled for D·M host devices (this process sets ``XLA_FLAGS`` before it
imports jax).  Beside the FLOPs it prints rank 0's memory
(``dryrun.trace_cell``: arguments, outputs, temporaries) against the
reference's ``memory_analysis()``, and each one's collective bytes a
device by kind (the port's from ``count_fn``'s record, the reference's
from its compiled HLO).  The train cell takes 16 sequences (4 under
``--opt``), so each microbatch splits over 'data'; ``--opt``'s sequences
are longer than its 2048-token chunks, so the triangular recursion splits.
``--src`` points at another checkout's ``src`` (a parent commit's, one
that has ``launch.dryrun.trace_cell``) for the port's side.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

CELLS = {"train": (64, 8), "prefill": (64, 4), "decode": (64, 4)}
MESH_CELLS = {False: {"train": (64, 16), "prefill": (64, 4), "decode": (64, 4)},
              True: {"train": (4096, 4), "prefill": (8192, 2), "decode": (64, 4)}}
SHAPE_NAMES = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
ARCH = "qwen2.5-3b"


def one_rank() -> None:
    import jax
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro import configs as rconfigs
    from repro.analysis import flops as rflops
    from repro.configs.base import ShapeConfig as RShapeConfig
    from repro.distributed.context import activation_mesh as ractivation_mesh
    from repro.launch import specs as rspecs
    from repro_torch import configs
    from repro_torch.analysis import flops
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_host_mesh

    builders = {"train": "_build_train", "prefill": "_build_prefill", "decode": "_build_decode"}
    rmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for kind, (seq, batch) in CELLS.items():
        rcfg = rconfigs.reduced(ARCH)
        fn, args = getattr(rspecs, builders[kind])(rcfg, RShapeConfig(kind, seq, batch, kind), rmesh)
        with rmesh, ractivation_mesh(rmesh):
            want = rflops.count_fn(fn, *args)
        cfg = configs.reduced(ARCH)
        with dryrun.fake_world(1):
            dev = dryrun.fake_device()
            mesh = make_host_mesh(1, 1, device=dev)
            with FakeTensorMode(allow_non_fake_inputs=True), activation_mesh(mesh):
                fn, args = getattr(specs, builders[kind])(cfg, ShapeConfig(kind, seq, batch, kind), mesh, dev)
                got = flops.count_fn(fn, *args)
        print(json.dumps({"cell": f"reduced {ARCH} {kind} (seq {seq}, batch {batch})",
                          "port_flops": got["flops"], "reference_flops": want["flops"],
                          "flops_ratio": got["flops"] / want["flops"],
                          "port_hbm_bytes": got["hbm_bytes"], "reference_hbm_bytes": want["hbm_bytes"],
                          "hbm_bytes_ratio": got["hbm_bytes"] / want["hbm_bytes"]}), flush=True)


def on_mesh(data: int, model: int, opt: bool) -> None:
    import jax

    from repro import configs as rconfigs
    from repro.analysis import flops as rflops
    from repro.analysis import roofline as rroofline
    from repro.configs.base import ShapeConfig as RShapeConfig
    from repro.distributed.context import activation_mesh as ractivation_mesh
    from repro.launch import specs as rspecs
    from repro_torch import configs
    from repro_torch.analysis import roofline
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_host_mesh

    import torch

    assert jax.device_count() == data * model, jax.device_count()
    rcfg, cfg = rconfigs.reduced(ARCH), configs.reduced(ARCH)
    rconfigs.get, configs.get = (lambda arch: rcfg), (lambda arch: cfg)
    rmesh = jax.make_mesh((data, model), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for kind, (seq, batch) in MESH_CELLS[opt].items():
        name = SHAPE_NAMES[kind]
        rspecs.SHAPES[name] = RShapeConfig(name, seq, batch, kind)
        specs.SHAPES[name] = ShapeConfig(name, seq, batch, kind)
        fn, args, jit_kwargs = rspecs.build_cell(rspecs.Cell(ARCH, name), rmesh, opt=opt)
        with rmesh, ractivation_mesh(rmesh):
            want = rflops.count_fn(fn, *args)
            compiled = jax.jit(fn, **jit_kwargs).lower(*args).compile()
        mem = compiled.memory_analysis()
        rcoll = rroofline.collective_bytes(compiled.as_text())
        with dryrun.fake_world(data * model):
            dev = dryrun.fake_device()
            mesh = make_host_mesh(data, model, device=dev)
            got, memory, _ = dryrun.trace_cell(specs.Cell(ARCH, name), mesh, opt=opt, device=dev)
        coll = roofline.collective_bytes(got["collectives"])
        print(json.dumps({
            "cell": f"reduced {ARCH} {kind} (seq {seq}, batch {batch}){' --opt' if opt else ''} on {data}x{model}",
            "torch": torch.__version__,
            "port_flops": got["flops"], "reference_flops": want["flops"],
            "port_memory": memory,
            "reference_memory": {"argument_bytes": int(mem.argument_size_in_bytes),
                                 "output_bytes": int(mem.output_size_in_bytes),
                                 "temp_bytes": int(mem.temp_size_in_bytes),
                                 "alias_bytes": int(mem.alias_size_in_bytes)},
            "port_collectives": {k: v for k, v in coll.items() if k != "total_raw"},
            "reference_collectives": {k: v for k, v in rcoll.items() if k != "total_raw"},
        }), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", help="DxM: run each package's build_cell on a (data, model) mesh")
    ap.add_argument("--opt", action="store_true", help="with --mesh: the hill-climb variants")
    ap.add_argument("--src", help="the port's source root (default: this checkout's)")
    opts = ap.parse_args()
    if opts.src:
        sys.path.insert(0, os.path.abspath(opts.src))
    if not opts.mesh:
        one_rank()
        return
    data, model = (int(n) for n in opts.mesh.split("x"))
    # before jax is imported: the reference's host devices
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={data * model}"
    on_mesh(data, model, opts.opt)


if __name__ == "__main__":
    main()
