"""K3's share of its roofline: the bound of every fused push-back wave the
window ran (``perfbench.arith.kernel_bytes``) over K3's device time in the
profiler's trace."""


def read(rec):
    if rec.trace is None or rec.trace.busy_s is None or not rec.k3_bound_s:
        return None
    secs, launches = rec.trace.op_seconds("push_back_kernel")
    if not launches:
        return None
    return 100.0 * rec.k3_bound_s / secs
