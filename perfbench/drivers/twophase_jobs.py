"""The paper's two-phase job (§VI), run back to back.

One job: a fresh ``TwoPhasePipeline``, the configuration's waves appended
(``start_size``, then ``duplications`` waves that each double the array;
``nblocks × ⌈size/nblocks⌉`` lanes a wave, the lanes below the wave's size
masked in by a device bool mask), ``freeze()``, the regular phase
(``+1``, ``rw_op_repeats`` times, through ``map_frozen``), then release.
The wave values are uniform random in the configuration's dtype, made on
the device from the seed at set-up and offered to every job.  Set-up runs
one whole job.  The window runs jobs while its seconds last and ends when
the last job started in it completes on the device.

Growth must never move a level (the levels' storage is compared before
and after each append), the capacity must keep to the §V bound, and the
last job's frozen array is held element for element to the plain
reference's rebuilt order (``perfbench.reference.sec6_order``).  A
control run (``perfbench/control.py``) puts the reference's own array,
computed in bf16, in the frozen array's place and judges it the same way.
"""
from __future__ import annotations

import gc
import statistics
import time

from perfbench.arith import kernel_bytes
from perfbench.reference import sec6_order
from perfbench.tracing import DeviceTrace, Spans


def duplication_sizes(start: int, duplications: int) -> list[int]:
    """The §VI schedule as wave sizes: ``start``, then ``duplications``
    waves that each double the array."""
    return [start] + [start << k for k in range(duplications)]


def _levels(pipe) -> set:
    return {(t.data_ptr(), t.numel() * t.element_size()) for t in pipe.array.buckets}


def run(ctx):
    import torch

    from repro_torch.runtime import TwoPhasePipeline

    conf, rec = ctx.config, ctx.record
    dev = torch.device(ctx.device)
    on_card = dev.type == "cuda"
    n, b0, reps = conf["nblocks"], conf["b0_per_block"], conf["rw_op_repeats"]
    dtype = getattr(torch, conf["dtype"])
    method = conf["deployment"]["append_method"]
    sizes = duplication_sizes(conf["start_size"], conf["duplications"])
    live = sum(sizes)
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    waves, masks = [], []
    for size in sizes:
        m = -(-size // n)
        waves.append(torch.rand((n, m), generator=gen, device=dev, dtype=dtype))
        masks.append((torch.arange(n * m, device=dev) < size).reshape(n, m))
    spans = Spans()

    def event():
        if not on_card:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(a, b) -> float:
        return a.elapsed_time(b) if a is not None else 0.0

    def work(x):
        for _ in range(reps):
            x = x + 1
        return x

    def collect() -> None:
        """A dropped pipeline refers to itself (its stats read its
        planner), so its arrays go only when the cyclic collector runs."""
        with spans.span("job.release"):
            gc.collect()

    def job() -> tuple:
        with spans.span("job.init"):
            pipe = TwoPhasePipeline(n, b0=b0, dtype=dtype, device=dev)
        moved = 0
        ev = [event()]
        with spans.span("job.append"):
            for elems, mask in zip(waves, masks):
                before = _levels(pipe)
                pipe.append(elems, mask, method=method)
                moved += sum(nbytes for _, nbytes in before - _levels(pipe))
        ev.append(event())
        cap = pipe.memory_elems()
        ev.append(event())
        with spans.span("job.freeze"):
            pipe.freeze()
        ev.append(event())
        with spans.span("job.map_frozen"):
            pipe.map_frozen(work)
        ev.append(event())
        return pipe, {"events": ev, "capacity": cap, "moved": moved}

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    pipe, _ = job()  # warm-up: every kernel and every allocation of a job
    pipe = None
    collect()
    gc.freeze()  # what set-up made stays: the collector walks only the jobs' objects
    sync()

    jobs = []
    with DeviceTrace(ctx.trace) as dt:
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        sync()
        t0 = time.perf_counter()
        e0 = event()
        rec.setup_s = t0 - ctx.t_start
        while True:
            pipe, jr = job()
            jobs.append(jr)
            if time.perf_counter() - t0 >= ctx.seconds:
                break
            pipe = None  # released before the next job starts
            collect()
        sync()
        t_close = time.perf_counter()
        dt.close(t0, t_close)
    gc.unfreeze()
    rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) if on_card else 0
    rec.peak_mem_bytes = rec.memory_peak_bytes if on_card else None
    rec.window_s = ms(e0, jobs[-1]["events"][-1]) / 1e3 if on_card else t_close - t0
    rec.jobs = len(jobs)
    rec.twophase_job_s = rec.window_s / len(jobs)
    rec.insert_ms = statistics.median(ms(j["events"][0], j["events"][1]) for j in jobs) if on_card else None
    rec.freeze_ms = statistics.median(ms(j["events"][2], j["events"][3]) for j in jobs) if on_card else None
    rec.alloc_over_live = jobs[-1]["capacity"] / live
    rec.k3_bound_s = len(jobs) * sum(
        kernel_bytes.push_back_bound_s(n, w.shape[1], size, w.element_size()) for w, size in zip(waves, sizes))
    rec.attempted = len(jobs)
    if dt.busy_s is not None:
        dt.attribute_idle(spans.items)
    rec.trace = dt

    # ---- correctness: the last job's frozen array and every job's bounds --
    frozen = pipe.frozen
    got = sec6_order.frozen_mismatches(frozen.data, waves, sizes, reps)
    n_frozen = int(frozen.size.item())
    if ctx.control:  # the reference itself, in the precision below the configuration's, in the program's place
        capacity = frozen.data.shape[0]
        del frozen, pipe
        program = got
        got = sec6_order.frozen_mismatches(sec6_order.rebuild(waves, sizes, reps, capacity, torch.bfloat16),
                                           waves, sizes, reps)
        rec.control = {"program_mismatches": program["mismatches"], "control_mismatches": got["mismatches"]}
    bound = 2 * live + b0 * n
    rec.checks += [
        ("mismatches", got["mismatches"], conf["limits"]["mismatches"]),
        ("tail_nonzero", got["tail_nonzero"], conf["limits"]["tail_nonzero"]),
        ("missing_elements", abs(n_frozen - got["expected_elements"]) + abs(live - got["expected_elements"]),
         conf["limits"]["missing_elements"]),
        ("capacity_over_bound", max(j["capacity"] for j in jobs) - bound, conf["limits"]["capacity_over_bound"]),
        ("copied_bytes", sum(j["moved"] for j in jobs), conf["limits"]["copied_bytes"]),
    ]
    rec.failed = 0 if all(v <= lim for _, v, lim in rec.checks) else 1
    return rec
