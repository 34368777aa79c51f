"""Multi-pod dry-run — port of ``repro/launch/dryrun.py``.

For every (architecture × input shape) cell, on the 16×16 single-pod mesh
and the 2×16×16 multi-pod mesh: start PyTorch's ``fake`` process group
(``FakeStore``) with 256 or 512 ranks, this process rank 0, build
``launch/mesh.py::make_production_mesh`` on it, and run the cell's step
once under ``FakeTensorMode`` and ``activation_mesh(mesh)`` on fake
``cuda`` tensors (:func:`fake_device`): the step follows the card's path (a
hand-written kernel's wrapper takes its shape rule on a fake tensor,
``kernels.common.run_kernel``), yet nothing is computed or allocated and
no card is needed.  This is the reference's own
arrangement, which lowers on host placeholders.  The step runs under
``analysis.flops.count_fn``: FLOPs, traffic, collectives and the peak of
live tensor bytes on rank 0.

Results are cached per cell under the git-ignored ``results/dryrun_torch/``,
one JSON a (cell, mesh, variant), so the sweep resumes; ``--force`` reruns.
A cell that fails records its error and traceback: failures here are faults
of the port.  Keys that differ from the reference's on purpose:
``trace_s`` (for ``lower_s``/``compile_s``), ``cost_flop_counter`` (the
formulas ``torch.utils.flop_counter.FlopCounterMode`` applies, on the same
ops: the second opinion, as XLA's ``cost_analysis`` was),
``cost_global`` (for ``cost_jaxpr_global``), ``fits_80gb`` (for
``fits_16gb``: an H100's 80 GB), and a gzipped per-op trace (op, input
shapes, flops, bytes) for the gzipped HLO.

Memory is rank 0's: argument, output and aliased bytes are its local
shards' (aliased: outputs written in place into a donated argument), temp
the step's peak of live bytes beyond the arguments and the outputs, and
``hbm_used`` = argument + output + temp − alias, as the reference's.

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
    [--results-dir DIR]

``tools/dryrun_sweep.py`` runs the cells in several processes at once,
``tools/dryrun_compare.py`` compares two sweeps' folders.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.analysis import flops as flops_mod
from repro_torch.analysis import roofline
from repro_torch.configs import SHAPES
from repro_torch.distributed.context import activation_mesh, is_dtensor, placements
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import Cell, build_cell, plan_cells
from repro_torch.tree import leaves, tree_map

__all__ = ["run_cell", "trace_cell", "fake_world", "fake_device", "RESULTS_DIR", "HBM_BYTES"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")
HBM_BYTES = 80e9  # one H100's device memory


@contextlib.contextmanager
def fake_world(ranks: int):
    """PyTorch's ``fake`` process group of ``ranks`` ranks, this process
    rank 0: collectives return at once and move nothing.  On a CPU-only
    build (:func:`fake_device`) DTensor's shard-to-shard redistribution
    issues the card's all-to-all here too, not its CPU form (an all-gather
    and a chunk, which would inflate the collective record and the
    temporaries): the fake group serves either."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=ranks)
    try:
        with _card_alltoall() if fake_device() == "cpu" else contextlib.nullcontext():
            yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _card_alltoall():
    """Within the block, ``placement_types.shard_dim_alltoall`` takes the
    branch it takes for a card's mesh (``torch.ops._dtensor.
    shard_dim_alltoall``) on a CPU mesh too."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    orig = placement_types.shard_dim_alltoall

    def card_form(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                     funcol._resolve_group_name((mesh, mesh_dim)))

    placement_types.shard_dim_alltoall = card_form
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def fake_device() -> str:
    """The device type the fake tensors and the mesh are labelled with:
    ``cuda`` where PyTorch is built with CUDA (no card needed).  A CPU-only
    build cannot copy a non-contiguous fake ``cuda`` tensor (``.contiguous()``
    raises "not linked with support for cuda devices"), so there the label
    is ``cpu``: the kernel wrappers take their shape rules on any fake
    tensor, and :func:`fake_world` keeps DTensor's collectives the card's."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _result_path(cell: Cell, multi_pod: bool, opt: bool = False, results_dir: str | None = None) -> str:
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{mesh_tag}__opt" if opt else mesh_tag
    return os.path.join(results_dir or RESULTS_DIR, f"{cell.arch}__{cell.shape}__{tag}.json")


def _local_bytes(tree, only=None) -> tuple[int, set]:
    """Rank 0's bytes of a tree's tensors (a ``DTensor``'s local shard),
    each storage once → (bytes, storage keys)."""
    seen: dict[int, int] = {}
    for t in leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        local = t._local_tensor if is_dtensor(t) else t
        st = local.untyped_storage()
        if only is None or st._cdata in only:
            seen[st._cdata] = st.nbytes()
    return sum(seen.values()), set(seen)


def _apply_out_specs(out, specs, mesh):
    """Lay the step's outputs out as ``specs`` says (prefill's
    ``out_shardings``): a ``DTensor`` leaf redistributed to its spec."""
    return tree_map(lambda t, spec: t.redistribute(mesh, placements(spec, mesh)) if is_dtensor(t) else t,
                    out, specs)


class _FlopFormulas:
    """The second opinion: ``torch.utils.flop_counter``'s formulas (those
    ``FlopCounterMode`` applies) on every op the counter sees."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0

    def __call__(self, func, args, kwargs, out, scale):
        f = self.registry.get(func._overloadpacket)
        if f is not None:
            self.flops += scale * f(*args, **kwargs, out_val=out)


def trace_cell(cell: Cell, mesh, *, opt: bool = False, device: str = "cuda",
               trace: bool = False) -> tuple[dict, dict, float]:
    """One cell's step, run once on ``mesh`` (a fake process group of its
    ranks started by the caller) under ``FakeTensorMode``,
    ``activation_mesh`` and ``count_fn`` → (``count_fn``'s counts, rank 0's
    memory as the module docstring defines it, the FLOPs of
    ``torch.utils.flop_counter``'s formulas)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    # DTensor's redistributions may index fake shards with small real index
    # tensors of their own (analysis.flops)
    with FakeTensorMode(allow_non_fake_inputs=True), activation_mesh(mesh):
        step, args, opts = build_cell(cell, mesh, opt=opt, device=device)
        donated = [args[i] for i in opts.get("donate", ())]
        arg_bytes, _ = _local_bytes(args)
        _, donated_keys = _local_bytes(donated)
        formulas = _FlopFormulas()

        def run(*a):
            res = step(*a)
            if "out_specs" in opts:
                res = _apply_out_specs(res, opts["out_specs"], mesh)
            return res

        jcount = flops_mod.count_fn(run, *args, trace=trace, formulas=formulas)
        result = jcount.pop("result")
        out_bytes, _ = _local_bytes(result)
        alias_bytes, _ = _local_bytes(result, only=donated_keys)
    temp = max(jcount["peak_bytes"] - (arg_bytes + out_bytes - alias_bytes), 0)
    hbm_used = int(arg_bytes + out_bytes + temp - alias_bytes)
    memory = dict(argument_bytes=int(arg_bytes), output_bytes=int(out_bytes), temp_bytes=int(temp),
                  alias_bytes=int(alias_bytes), hbm_used_bytes=hbm_used, fits_80gb=bool(hbm_used < HBM_BYTES))
    return jcount, memory, formulas.flops


def run_cell(cell: Cell, *, multi_pod: bool, force: bool = False, opt: bool = False,
             results_dir: str | None = None) -> dict:
    results_dir = results_dir or RESULTS_DIR
    path = _result_path(cell, multi_pod, opt, results_dir)
    if not force and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    os.makedirs(results_dir, exist_ok=True)

    out: dict = {
        "cell": cell.name,
        "arch": cell.arch,
        "shape": cell.shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256,
        "fake_device": fake_device(),
        "torch": torch.__version__,
    }
    if cell.skip_reason:
        out["status"] = "skipped"
        out["skip_reason"] = cell.skip_reason
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        return out

    t0 = time.monotonic()
    try:
        with fake_world(out["chips"]):
            dev = fake_device()
            mesh = make_production_mesh(multi_pod=multi_pod, device=dev)  # outside: reads its ranks
            jcount, memory, formula_flops = trace_cell(cell, mesh, opt=opt, device=dev, trace=True)
        t_trace = time.monotonic() - t0
        with gzip.open(path.replace(".json", ".ops.jsonl.gz"), "wt") as f:
            for name, shapes, fl, by in jcount.pop("ops"):
                f.write(json.dumps({"op": name, "shapes": shapes, "flops": fl, "bytes": by}) + "\n")
        coll = roofline.collective_bytes(jcount["collectives"])
        per_dev = {
            "flops": jcount["flops"] / out["chips"],
            "bytes accessed": jcount["hbm_bytes"] / out["chips"],
        }
        terms = roofline.roofline_terms(per_dev, coll)
        # the config build_cell traced (read now, as it read it)
        mf = roofline.model_flops(configs.get(cell.arch), SHAPES[cell.shape], out["chips"])
        out.update(
            status="ok",
            trace_s=round(t_trace, 1),
            memory=memory,
            cost_flop_counter={"flops": float(formula_flops)},
            cost_global={"flops": jcount["flops"], "hbm_bytes": jcount["hbm_bytes"]},
            collectives={k: round(v, 1) for k, v in coll.items()},
            collective_count=len(jcount["collectives"]),
            notes=jcount["notes"],
            roofline=terms,
            model_flops=mf,
            useful_flop_ratio=(
                mf["model_flops_per_device"] / terms["flops_per_device"]
                if terms["flops_per_device"] else None
            ),
        )
    except Exception as e:  # record the failure: these are faults of the port
        out.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", action="store_true", help="the hill-climb variants")
    ap.add_argument("--results-dir", help=f"where the JSONs go (default {RESULTS_DIR})")
    args = ap.parse_args()

    cells = plan_cells()
    if not args.all:
        cells = [
            c for c in cells
            if (not args.arch or c.arch == args.arch)
            and (not args.shape or c.shape == args.shape)
        ]
    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)

    # DTensor's sharding rules, and so rank 0's memory, may differ between
    # torch versions: each cell's JSON names both
    print(f"# fake tensors labelled {fake_device()}, torch {torch.__version__}", flush=True)
    failures = 0
    for cell in cells:
        for multi_pod in meshes:
            tag = "2x16x16" if multi_pod else "16x16"
            r = run_cell(cell, multi_pod=multi_pod, force=args.force, opt=args.opt,
                         results_dir=args.results_dir)
            status = r["status"]
            extra = ""
            if status == "ok":
                extra = (
                    f" hbm/dev={r['memory']['hbm_used_bytes'] / 1e9:.2f}GB"
                    f" bound={r['roofline']['bound']}"
                    f" trace={r.get('trace_s', 0):.0f}s"
                )
            elif status == "error":
                failures += 1
                extra = " " + r["error"][:140]
            print(f"[{status:7s}] {cell.name:44s} mesh={tag}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
