"""Host spans and the device trace of one measured window.

``Spans`` records the benchmark's own spans around its calls into the
program, on the host clock (``time.perf_counter``); a list append each, so
they stay on in every run.  ``DeviceTrace`` runs ``torch.profiler`` over
the window in a ``--trace 1`` run (CUDA activity only: the card's kernels,
copies and fills) and reduces it to what the per-layer metrics read: the
seconds in which any device operation ran (the union of their
intervals), device time and launch count by operation name, and the idle
time between operations attributed to the innermost host span open at
each gap (the benchmark's spans and any the program recorded).

The profiler stamps events on the wall clock in nanoseconds; host spans
are moved onto it by the offset between ``time.time_ns`` and
``time.perf_counter_ns`` taken when the window opens.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import sys
import time


class Spans:
    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))


def _segments(spans: list[tuple[str, float, float]]) -> tuple[list[float], list[str]]:
    """Properly nested spans → a partition of the time line into segments,
    each named by the innermost span open there ("bench loop" where
    none is)."""
    times, names = [], []
    stack: list[tuple[float, str]] = []
    outside = "bench loop"

    def mark(t: float, name: str) -> None:
        if times and times[-1] == t:
            names[-1] = name
        else:
            times.append(t)
            names.append(name)

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][0] <= s:
            end, _ = stack.pop()
            mark(end, stack[-1][1] if stack else outside)
        stack.append((e, name))
        mark(s, name)
    while stack:
        end, _ = stack.pop()
        mark(end, stack[-1][1] if stack else outside)
    return times, names


class DeviceTrace:
    """``with DeviceTrace(enabled) as dt: …; dt.close(t0, t1)`` — the
    profiler runs between ``__enter__`` and ``close``; ``t0``/``t1`` bound
    the window on the host clock."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.busy_s = None
        self.window_s = None
        self.ops: dict[str, list] = {}  # name → [seconds, launches]
        self.idle_by_host: dict[str, float] = {}
        self._offset_ns = 0
        self._gaps: list[tuple[float, float]] = []

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            self.prof = None

    def close(self, t0: float, t1: float) -> None:
        """Stop the profiler and reduce its events inside [t0, t1] (host
        perf_counter seconds)."""
        if self.prof is None:
            return
        t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)
        t_read = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        t_reduce = time.perf_counter()
        lo = t0 * 1e9 + self._offset_ns
        hi = t1 * 1e9 + self._offset_ns
        ivals = []
        ops: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
        for e in events:
            if not str(e.device_type()).endswith("CUDA") or e.is_user_annotation():
                continue
            s, d = e.start_ns(), e.duration_ns()
            a, b = max(s, lo), min(s + d, hi)
            if b <= a:
                continue
            ivals.append((a, b))
            op = ops[e.name()]
            op[0] += (b - a) / 1e9
            op[1] += 1
        ivals.sort()
        busy, gaps, cur_a, cur_b = 0.0, [], None, lo
        for a, b in ivals:
            if cur_a is None or a > cur_b:
                if cur_a is not None:
                    busy += cur_b - cur_a
                if a > cur_b:
                    gaps.append((cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_a is not None:
            busy += cur_b - cur_a
        if cur_b < hi:
            gaps.append((cur_b, hi))
        print(f"trace: profiler stop {t_read - t_stop:.1f} s, {len(events)} events read in "
              f"{t_reduce - t_read:.1f} s, reduced in {time.perf_counter() - t_reduce:.1f} s",
              file=sys.stderr, flush=True)
        self.busy_s = busy / 1e9
        self.window_s = t1 - t0
        self.ops = dict(ops)
        self._gaps = [((a - self._offset_ns) / 1e9, (b - self._offset_ns) / 1e9) for a, b in gaps]

    def attribute_idle(self, spans: list[tuple[str, float, float]]) -> None:
        """Sum the idle gaps by the innermost host span open at each gap's
        middle (host perf_counter seconds)."""
        if self.busy_s is None:
            return
        times, names = _segments(spans)
        idle: dict[str, float] = collections.defaultdict(float)
        for a, b in self._gaps:
            i = bisect.bisect_right(times, (a + b) / 2) - 1
            idle[names[i] if i >= 0 else "bench loop"] += b - a
        self.idle_by_host = dict(idle)

    def op_seconds(self, needle: str) -> tuple[float, int]:
        """Device seconds and launches of the operations whose name holds
        ``needle``."""
        secs, n = 0.0, 0
        for name, (s, c) in self.ops.items():
            if needle in name:
                secs += s
                n += c
        return secs, n

    def breakdown(self) -> dict:
        ops = sorted(((name, s) for name, (s, _) in self.ops.items()), key=lambda x: -x[1])[:10]
        idle = sorted(self.idle_by_host.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}
