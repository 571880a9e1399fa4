"""The profiler over a traced phase, and its reduction to the device's
busy time, each kernel's time and the breakdown.

The phase runs twice, each time in one `torch.profiler` session.  The
first records the device alone, so the host runs at its own pace: its
busy time, window and kernels give the metrics.  The second records the
host too, which slows the host by some microseconds an operation: it only
names the idle gaps.

The reduction reads the exported Chrome trace: device work is every
kernel, copy and memset event; the device-side ranges of
`record_function` spans (`gpu_user_annotation`) are not work and are left
out.  The window is the `bench.traced` span where the host was recorded,
else the device's first to last event.  Idle gaps are named by what the
host was doing at their middle: the innermost span of the benchmark's
own (`user_annotation`) and the innermost host operation (an ATen op or a
CUDA runtime call).
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.traced"


@dataclass
class Profile:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)     # short name -> [seconds, launches]
    device_ops: list = field(default_factory=list)  # [[name, seconds]], most time first
    idle_gaps: list = field(default_factory=list)   # [[host activity, seconds]]

    def kernel_seconds(self, *names: str) -> float:
        return sum(self.kernels[n][0] for n in names if n in self.kernels)


def span(name: str):
    """A span of the benchmark's own around a call into a layer: a
    `record_function` range while the profiler records, else nothing."""
    import torch

    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def short_name(name: str) -> str:
    """A kernel's name without `void `, anonymous namespaces, its template
    arguments and its parameter list: `void (anonymous
    namespace)::select_kernel<false>(...)` -> `select_kernel`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("<")[0].split("(")[0].strip()


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(events, points, default: str) -> list:
    """For each time in `points`, the name of the shortest event of
    `events` (start, end, name) that holds it, or `default`."""
    if not events or not len(points):
        return [default] * len(points)
    a = np.array([e[0] for e in events])
    b = np.array([e[1] for e in events])
    width = b - a
    out = []
    for lo in range(0, len(points), 256):
        t = np.asarray(points[lo:lo + 256])[:, None]
        w = np.where((a <= t) & (t <= b), width, np.inf)
        k = w.argmin(axis=1)
        hit = np.isfinite(w[np.arange(len(k)), k])
        out += [events[i][2] if h else default for i, h in zip(k, hit)]
    return out


def reduce(events: list) -> Profile:
    """Chrome-trace events -> Profile over the `bench.traced` span."""
    win = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation"]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
    else:
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        if not dev:
            raise ValueError(f"the trace has no {WINDOW_SPAN!r} span and no device event")
        w0 = min(float(e["ts"]) for e in dev)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in dev)
    dev, spans, ops = [], [], []
    kernels = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            lo, hi = max(a, w0), min(b, w1)
            if hi > lo:
                dev.append((lo, hi))
            if a >= w0 and b <= w1:
                k = kernels[short_name(e["name"])]
                k[0] += float(e["dur"]) * 1e-6
                k[1] += 1
        elif cat == "user_annotation" and e["name"] != WINDOW_SPAN:
            spans.append((a, b, e["name"]))
        elif cat in HOST_CATS:
            ops.append((a, b, e["name"]))
    busy = _merge(dev)
    gaps = []
    edge = w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    mids = [0.5 * (a + b) for a, b in gaps]
    idle = defaultdict(float)
    for (a, b), span, op in zip(gaps, _innermost(spans, mids, "(no span)"),
                                _innermost(ops, mids, "python")):
        idle[f"{span}: {op}"] += (b - a) * 1e-6
    ops_by_time = sorted(([n, v[0]] for n, v in kernels.items()), key=lambda x: -x[1])
    return Profile(window_s=(w1 - w0) * 1e-6,
                   busy_s=sum(b - a for a, b in busy) * 1e-6,
                   kernels=dict(kernels),
                   device_ops=ops_by_time[:10],
                   idle_gaps=sorted(([n, s] for n, s in idle.items()), key=lambda x: -x[1])[:10])


def _session(fn, acts, path: str) -> list:
    import torch

    card = torch.cuda.is_available()
    if card:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            fn()
            if card:
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def profiled(fn, trace_path: str) -> Profile:
    """Run fn() twice under the profiler, inside the `bench.traced` span
    and ending in a synchronise: the device alone, then host and device
    (without a card, the host alone, once).  Writes the traces beside
    `trace_path`; returns the first's Profile with the second's idle
    gaps."""
    import torch

    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    cpu = torch.profiler.ProfilerActivity.CPU
    if torch.cuda.is_available():
        cuda = torch.profiler.ProfilerActivity.CUDA
        out = reduce(_session(fn, [cuda], trace_path))
        named = reduce(_session(fn, [cpu, cuda], trace_path.replace(".json", ".host.json")))
        out.idle_gaps = named.idle_gaps
    else:
        out = reduce(_session(fn, [cpu], trace_path))
    return out
