"""Tracing: `torch.profiler` traces, and the port's spans and counters.

Counterpart of `dsr_tpu/utils/profiling.py`, and the port's one tracer.

- `trace(log_dir)` records the host and, where a card is present, the
  device, and writes a Chrome/Perfetto trace
  (`<host>.<pid>.<ns>.pt.trace.json`, the file name TensorBoard's
  profiler plugin reads) into `log_dir`.
- `scope(name, device=False)` is a span.  With no profiler running and the
  recorder off it returns one shared null context: one flag check and
  `torch.autograd._profiler_enabled()`, nothing allocated, no device call.
  While `torch.profiler` records, the span is a `record_function` range,
  in the trace on the kernels' clock.  While the recorder is on
  (`recording()`), the span is also kept in memory: its name, its parent,
  its request (the outermost span it sits in: one `decode_batch` call, one
  front-end call), its host start and end (`time.perf_counter_ns`) and,
  when `device` names a CUDA device, a pair of CUDA events on that
  device's current stream, resolved only by `snapshot()`.  On the CPU
  device the device time is the host time: the work is done on return.
- `count(name, n)` adds n to a named counter while the recorder is on: a
  host int, or a tensor summed on its device and read only by `snapshot()`.
- `snapshot()` reads the last recording: spans summed by name
  (`host_s`, `device_s`, `self_host_s`, `count`) and every counter, the
  `ops/cuda` wrappers' `launches` among them (`launches()`).

Spans are kept in memory in a bounded list (`MAX_SPANS`, the oldest
dropped first and counted); the recorder writes nothing to disk.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import socket
import threading
import time

import torch

MAX_SPANS = 1 << 16

_NULL = contextlib.nullcontext()
_recorder = None       # the _Recorder while `recording()` is on
_last = None           # the last recording, read by `snapshot()`


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


class _Record:
    __slots__ = ("name", "seq", "parent", "request", "t0", "t1", "events", "host_device")

    def __init__(self, name, seq, parent, request, events, host_device):
        self.name, self.seq, self.parent, self.request = name, seq, parent, request
        self.events, self.host_device = events, host_device
        self.t1 = None
        self.t0 = time.perf_counter_ns()


class _Recorder:
    def __init__(self):
        self.spans = collections.deque(maxlen=MAX_SPANS)
        self.seq = itertools.count()
        self.open = threading.local()       # the open spans of each thread, innermost last
        self.counts = collections.Counter()
        self.device_counts = {}              # name -> 0-d int64 tensor

    def enter(self, name, device):
        stack = getattr(self.open, "stack", None)
        if stack is None:
            stack = self.open.stack = []
        seq = next(self.seq)
        parent = stack[-1] if stack else None
        dev = torch.device(device) if device else None
        events = None
        if dev is not None and dev.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True),
                      torch.cuda.current_stream(dev))
            events[0].record(events[2])
        rec = _Record(name, seq, parent.seq if parent else -1,
                      parent.request if parent else seq, events,
                      dev is not None and dev.type == "cpu")
        if len(self.spans) == self.spans.maxlen:
            self.counts["profiling.spans_dropped"] += 1
        self.spans.append(rec)
        stack.append(rec)
        return rec

    def exit(self, rec):
        rec.t1 = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record(rec.events[2])
        self.open.stack.pop()


class _Scope:
    __slots__ = ("name", "device", "range", "recorder", "record")

    def __init__(self, name, device):
        self.name, self.device = name, device

    def __enter__(self):
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.recorder = _recorder
        if self.recorder is not None:
            self.record = self.recorder.enter(self.name, self.device)
        return self

    def __exit__(self, *exc):
        if self.recorder is not None:
            self.recorder.exit(self.record)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def scope(name: str, device=False):
    """A named span (see the module docstring); `device`: the torch device
    whose work the span also times, or False."""
    if _recorder is None and not torch.autograd._profiler_enabled():
        return _NULL
    return _Scope(name, device)


def is_recording() -> bool:
    return _recorder is not None


@contextlib.contextmanager
def recording():
    """Turn the in-memory recorder on for the body (a fresh recording,
    which `snapshot()` reads during and after it)."""
    global _recorder, _last
    if _recorder is not None:
        raise RuntimeError("the recorder is already on")
    _recorder = _last = _Recorder()
    try:
        yield _recorder
    finally:
        _recorder = None


def count(name: str, n) -> None:
    """Add n (an int, or an integer tensor, added on its device) to the
    counter `name` while the recorder is on."""
    rec = _recorder
    if rec is None:
        return
    if isinstance(n, torch.Tensor):
        acc = rec.device_counts.get(name)
        if acc is None:
            rec.device_counts[name] = n.detach().to(torch.int64).reshape(()).clone()
        else:
            acc.add_(n.reshape(()))
    else:
        rec.counts[name] += int(n)


def launches() -> dict[str, int]:
    """The `ops/cuda` wrappers' kernel launches since their last
    `reset_launches()`, by kernel (their `launches` dicts, read as they are)."""
    from dsr_tpu_torch.ops.cuda import filterbank, gsc, select, steering, traceback, viterbi

    return {k: n for mod in (filterbank, gsc, select, steering, traceback, viterbi)
            for k, n in mod.launches.items()}


def snapshot() -> dict:
    """-> {"spans": {name: {"host_s", "device_s", "self_host_s", "count"}},
    "counters": {name: int}} of the last recording (spans still open are
    left out; `device_s` is None for spans that time no device).  Device
    times and counters are read here, which waits for their work."""
    rec = _last
    spans, counters = {}, {f"launches.{k}": n for k, n in launches().items()}
    if rec is None:
        return {"spans": spans, "counters": counters}
    done = [r for r in list(rec.spans) if r.t1 is not None]
    child_ns = collections.Counter()
    for r in done:
        child_ns[r.parent] += r.t1 - r.t0
    for r in done:
        s = spans.setdefault(r.name, {"host_s": 0.0, "device_s": None, "self_host_s": 0.0,
                                      "count": 0})
        host = (r.t1 - r.t0) * 1e-9
        s["host_s"] += host
        s["self_host_s"] += host - child_ns[r.seq] * 1e-9
        s["count"] += 1
        if r.events is not None:
            r.events[1].synchronize()
            s["device_s"] = (s["device_s"] or 0.0) + r.events[0].elapsed_time(r.events[1]) * 1e-3
        elif r.host_device:
            s["device_s"] = (s["device_s"] or 0.0) + host
    counters.update(rec.counts)
    for name, t in rec.device_counts.items():
        counters[name] = counters.get(name, 0) + int(t.item())
    return {"spans": spans, "counters": counters}

