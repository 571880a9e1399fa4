"""`synthesis_kernel`'s share of its roofline (`counts.synthesis`)."""

from bench_port.metrics._roofline import share


def read(ctx):
    return share(ctx, "synthesis", "synthesis_kernel")
