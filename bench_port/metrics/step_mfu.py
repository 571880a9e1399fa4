"""The whole window's work at the chip's peak over the window's wall time:
the least time of every layer's counts together (the larger of all bytes
over the memory's peak and all operations over the float32 peak), as a
share of the window."""

from bench_port import peaks


def read(ctx):
    w = ctx.window_work
    if w is None or (w.nbytes <= 0 and w.flops <= 0):
        return None
    return peaks.least_seconds(w.nbytes, w.flops) / ctx.window_s * 100
