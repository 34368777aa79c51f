#!/usr/bin/env python3
"""The port's step counter against the reference's on reduced cells: the
FLOPs and modelled HBM bytes of ``repro_torch.analysis.flops.count_fn`` over
the port's train, prefill and decode steps of reduced qwen2.5-3b, and of
``repro.analysis.flops.count_fn`` over the reference's same steps, with
their ratios.

    PYTHONPATH=src python tools/count_vs_reference.py   # CPU only, a minute

A jaxpr equation and an aten op are not the same unit of traffic (XLA's
jaxpr keeps a fused ``dot_general`` where PyTorch dispatches a reshape, a
copy and an ``mm``), so the bytes ratio is a record, not a check; the
FLOPs are held by ``tests/test_torch_dryrun.py`` (the train step less the
reference's recomputed scores, which the port keeps).
"""
from __future__ import annotations

import json


def main() -> None:
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

    cells = {"train": (64, 8), "prefill": (64, 4), "decode": (64, 4)}
    builders = {"train": "_build_train", "prefill": "_build_prefill", "decode": "_build_decode"}
    rmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for kind, (seq, batch) in cells.items():
        rcfg = rconfigs.reduced("qwen2.5-3b")
        fn, args = getattr(rspecs, builders[kind])(rcfg, RShapeConfig(kind, seq, batch, kind), rmesh)
        with rmesh, ractivation_mesh(rmesh):
            want = rflops.count_fn(fn, *args)
        cfg = configs.reduced("qwen2.5-3b")
        with dryrun.fake_world(1):
            dev = dryrun.fake_device()
            mesh = make_host_mesh(1, 1, device=dev)
            with FakeTensorMode(allow_non_fake_inputs=True), activation_mesh(mesh):
                fn, args = getattr(specs, builders[kind])(cfg, ShapeConfig(kind, seq, batch, kind), mesh, dev)
                got = flops.count_fn(fn, *args)
        print(json.dumps({"cell": f"reduced qwen2.5-3b {kind} (seq {seq}, batch {batch})",
                          "port_flops": got["flops"], "reference_flops": want["flops"],
                          "flops_ratio": got["flops"] / want["flops"],
                          "port_hbm_bytes": got["hbm_bytes"], "reference_hbm_bytes": want["hbm_bytes"],
                          "hbm_bytes_ratio": got["hbm_bytes"] / want["hbm_bytes"]}), flush=True)


if __name__ == "__main__":
    main()
