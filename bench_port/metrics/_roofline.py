"""A kernel's share of its roofline in the traced phase: the least time
of the work its launches needed (`counts.py`, at `peaks.py`'s peaks) over
the device time the profiler gave its kernels."""

from bench_port import peaks


def share(ctx, layer: str, *kernels: str):
    if ctx.profile is None or layer not in ctx.profile_work:
        return None
    t = ctx.profile.kernel_seconds(*kernels)
    if t <= 0:
        return None
    w = ctx.profile_work[layer]
    return peaks.least_seconds(w.nbytes, w.flops) / t * 100
