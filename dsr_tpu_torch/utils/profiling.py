"""Tracing: `torch.profiler` traces with named scopes per pipeline stage
(audio-sec/s counters are `metrics.RtfMeter`).

Counterpart of `dsr_tpu/utils/profiling.py`.  `trace(log_dir)` records
the host and, where a card is present, the device, and writes a
Chrome/Perfetto trace (`<host>.<pid>.<ns>.pt.trace.json`, the file name
TensorBoard's profiler plugin reads) into `log_dir`; `scope(name)` is a
`torch.profiler.record_function` range, which shows in the trace.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body over the CPU and CUDA; yields the profiler, whose
    `trace_path` names the written trace after the body."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(prof.trace_path)


def scope(name: str):
    """Named range for pipeline stages (shows up in traces)."""
    return torch.profiler.record_function(name)


def annotate_fn(name: str):
    """Decorator: wrap a function in a named trace scope."""

    def deco(fn):
        def wrapper(*a, **k):
            with scope(name):
                return fn(*a, **k)

        return wrapper

    return deco
