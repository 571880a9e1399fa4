"""The share of the traced phase in which no kernel, copy or memset ran on
the device (profiler)."""


def read(ctx):
    if ctx.profile is None or ctx.profile.window_s <= 0:
        return None
    return (1 - ctx.profile.busy_s / ctx.profile.window_s) * 100
