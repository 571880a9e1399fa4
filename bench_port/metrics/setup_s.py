"""Process start to the first timed request: imports, builds, graph and
pool, warm-up."""


def read(ctx):
    return ctx.setup_s
