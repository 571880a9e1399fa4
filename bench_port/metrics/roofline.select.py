"""The select's share of its roofline (`counts.select`, the live
candidates): `select_kernel` with the `insert_kernel` and `keys_kernel`
launches of pools above 12,288 candidates."""

from bench_port.metrics._roofline import share


def read(ctx):
    return share(ctx, "select", "select_kernel", "insert_kernel", "keys_kernel")
