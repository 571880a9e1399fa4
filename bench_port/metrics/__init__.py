"""Metric readers: `<metric>.py` holds `read(ctx)`, the metric of one run
from `harness.Context`, or None when the run has nothing to read."""
