"""`analysis_beamform_kernel`'s share of its roofline (`counts.analysis_beamform`)."""

from bench_port.metrics._roofline import share


def read(ctx):
    return share(ctx, "analysis_beamform", "analysis_beamform_kernel")
