"""Share of the traced window in which no operation ran on the device
(the union of the profiler's device intervals)."""


def read(rec):
    if rec.trace is None or rec.trace.busy_s is None or not rec.trace.window_s:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
