#!/usr/bin/env python3
"""Which live tensors make rank 0's peak in a dry-run cell: by default the
qwen2.5-3b and dbrx-132b x decode_32k cells of ``repro_torch.launch.dryrun``
on the fake 16x16 mesh, with ``analysis.flops.Counter.track`` wrapped to
remember each storage's size, shape, dtype, device and the Python frames
that made it, and the largest dozen alive at the peak printed.

    python3 tools/dryrun_peak.py [--src SRC] [--label cpu|cuda] [--cell ARCH:SHAPE[:opt] ...]

``--cell`` picks other cells (``:opt`` the ``--opt`` variant), one line of
totals and the dozen rows each.

SRC: the port's source root, default src.  No card needed; on a CUDA build
the fake tensors are labelled ``cuda`` (``launch.dryrun.fake_device``),
elsewhere ``cpu``; ``--label cpu`` forces the CPU label on a CUDA build
(``--label cuda`` on a CPU-only build fails: it cannot copy a fake
``cuda`` tensor).
"""
import argparse
import sys
import traceback


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    ap.add_argument("--label", choices=("cpu", "cuda"))
    ap.add_argument("--cell", action="append", help="ARCH:SHAPE or ARCH:SHAPE:opt")
    opts = ap.parse_args()
    sys.path.insert(0, opts.src)
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from repro_torch.analysis import flops
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh

    made = {}
    track = flops.Counter.track

    def spy(self, tensors):
        before = set(self._seen)
        track(self, tensors)
        for t in tensors:
            local = t._local_tensor if isinstance(t, DTensor) else t
            if local.device.type == "meta":
                continue
            key = local.untyped_storage()._cdata
            if key in self._seen and key not in before:
                made[key] = (self._seen[key], tuple(local.shape), str(local.dtype), str(local.device),
                             [f.name for f in traceback.extract_stack(limit=16)][:-3])
        if self.live >= self.peak:
            self.at_peak = sorted((made[k] for k in self._seen if k in made), key=lambda x: -x[0])[:12]

    flops.Counter.track = spy
    counters = []
    init = flops.Counter.__init__

    def remember(self, *a, **k):
        init(self, *a, **k)
        counters.append(self)

    flops.Counter.__init__ = remember
    if opts.label:
        dryrun.fake_device = lambda: opts.label
    for name in opts.cell or ("qwen2.5-3b:decode_32k", "dbrx-132b:decode_32k"):
        arch, shape, *variant = name.split(":")
        with dryrun.fake_world(256):
            dev = dryrun.fake_device()
            mesh = make_production_mesh(device=dev)
            with FakeTensorMode(allow_non_fake_inputs=True), activation_mesh(mesh):
                step, args, _ = specs.build_cell(specs.Cell(arch, shape), mesh, device=dev,
                                                 opt=variant == ["opt"])
                got = flops.count_fn(step, *args)
        print(name, dev, "torch", torch.__version__, "peak", got["peak_bytes"], flush=True)
        for row in getattr(counters[-1], "at_peak", []):
            print("  ", row, flush=True)


if __name__ == "__main__":
    main()
