"""Run one cell of `BENCHMARK.json` once: set up, warm up, measure the
window, read the metrics, check the answers against the plain reference.

Everything is found by name:

- the cell's configuration: the `file` its `configs` entry names, whose
  `system` key names its module `systems/<system>.py`;
- its traffic mix: `traffic/<mix>.json`, whose `generator` names the
  generator in `generators/`;
- its limits and check sample: `limits/<cell>.json`;
- each metric: `metrics/<metric>.py`, a `read(ctx)` that returns a number,
  or None when it finds nothing to read (the metric is then left out).

A later cell, mix or metric is a new file; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
import time
from dataclasses import dataclass, field

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names the port must never load (compared whole:
# `dsr_tpu_torch` is the port and allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dsr_tpu", "golden")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


@dataclass
class Layout:
    """Where the data files are: the benchmark's own folders, or a test's."""
    traffic: pathlib.Path = ROOT / "traffic"
    limits: pathlib.Path = ROOT / "limits"
    metrics: pathlib.Path = ROOT / "metrics"


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """Import a file by path (metric files are named after their metric,
    dots included)."""
    name = "bench_port._loaded." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {workload!r}")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"BENCHMARK.json has no config {name!r}")


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metrics: its end-to-end ones with --trace 0, its
    per-layer ones with --trace 1."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


@dataclass
class Context:
    """What a metric's reader reads."""
    setup_s: float
    window_s: float
    audio_s: float
    latencies_s: np.ndarray
    spans: dict = field(default_factory=dict)        # name -> seconds
    counters: dict = field(default_factory=dict)
    profile: object = None                           # trace.Profile of the traced phase
    profile_work: dict = field(default_factory=dict)  # layer -> counts.Work, traced phase
    window_work: object = None                       # counts.Work of the whole window


@dataclass
class Cell:
    """A cell, its files resolved."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    system: object

    @classmethod
    def find(cls, bench: dict, workload: str, layout: Layout = Layout()) -> "Cell":
        w = cell_entry(bench, workload)
        file = pathlib.Path(config_entry(bench, w["config"])["file"])
        config = load_json(file if file.is_absolute() else REPO / file)
        return cls(workload, config, load_json(layout.traffic / f"{w['traffic']}.json"),
                   load_json(layout.limits / f"{workload}.json"),
                   load_module(ROOT / "systems" / f"{config['system']}.py"))


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, layout: Layout = Layout()):
    """One run of a cell -> (result dict without `checks`, checks
    [(name, value, limit)])."""
    import torch

    from bench_port import trace as tr

    cell = Cell.find(bench, workload, layout)
    on_card = torch.device(device).type == "cuda"
    model = cell.system.Model(cell.config, device)
    run_ = cell.system.Cell(model, cell.traffic, cell.limits, seed, spans=trace)
    run_.warm()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start
    t0, t1, lat, audio, attempted = run_.serve(seconds)
    ctx = Context(setup_s, t1 - t0, audio, lat)
    if trace:
        path = ROOT / "traces" / f"{workload}.json"
        ctx.profile = run_.trace(lambda fn: tr.profiled(fn, str(path)))
        ctx.spans = dict(run_.span_s)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run_.release()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    checks = run_.check()
    check_s = time.monotonic() - t_check
    ctx.profile_work, ctx.window_work = run_.work()
    ctx.counters = dict(run_.counters)
    values = {}
    for m in metrics_of(bench, workload, trace):
        v = load_module(layout.metrics / f"{m['name']}.py").read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for _, v, lim in checks), "attempted": int(attempted),
              "failed": 0, "metrics": values, "device": device_info}
    if trace:
        device_info["busy_s"] = ctx.profile.busy_s
        device_info["window_s"] = ctx.profile.window_s
        result["breakdown"] = {"device_ops": ctx.profile.device_ops,
                               "idle_gaps": ctx.profile.idle_gaps}
    info = {"setup_s": setup_s, "check_s": check_s, "window_s": ctx.window_s, **run_.counters}
    return result, checks, info
