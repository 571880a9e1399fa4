"""Fixtures of the benchmark's CPU tests: a tiny twin of every cell of
`BENCHMARK.json` in a temporary layout, run through the harness on the
CPU (the port's plain paths).  Tests that need the card carry the `chip`
marker and skip here, deciding inside the test.

Each cell's twin is data: `tiny/<cell>.json` names the twin (`twin`) and
patches the cell's configuration (`config`), traffic mix (`traffic`) and
limits (`limits`) as JSON merge patches (RFC 7386: an object merges into
the one it patches, `null` drops the key, anything else replaces it).  A
cell joins the CPU tests by adding its tiny file; nothing here names a
cell."""

import json
import os
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BENCH = REPO / "bench_port"
TINY = BENCH / "tests" / "tiny"


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


def load(rel: str) -> dict:
    with open(BENCH / rel) as f:
        return json.load(f)


def write(path: pathlib.Path, obj) -> pathlib.Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))
    return path


def merge_patch(target, patch):
    """`target` with the JSON merge patch `patch` applied (RFC 7386)."""
    if not isinstance(patch, dict):
        return patch
    out = dict(target) if isinstance(target, dict) else {}
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = merge_patch(out.get(k), v)
    return out


def tiny_files(bench: dict, tiny_dir: pathlib.Path = TINY) -> dict:
    """cell name -> its tiny file's contents, for every cell of `bench`."""
    out = {}
    for w in bench["workloads"]:
        path = tiny_dir / f"{w['name']}.json"
        if not path.exists():
            raise FileNotFoundError(
                f"the cell {w['name']!r} has no CPU twin: add {path} with its `twin` name and "
                "merge patches of its `config`, `traffic` and `limits` (see tiny/*.json)")
        with open(path) as f:
            out[w["name"]] = json.load(f)
    return out


def twin_names(tiny_dir: pathlib.Path = TINY) -> list:
    """The twins the tiny files name, for parametrising tests."""
    return sorted(json.loads(p.read_text())["twin"] for p in tiny_dir.glob("*.json"))


def twins(bench: dict, out: pathlib.Path, tiny_dir: pathlib.Path = TINY, source=None):
    """(bench, layout) of the twins of every cell of `bench`: each twin's
    configuration, mix and limits are the cell's (read from `source`, the
    benchmark's own layout by default) patched by its tiny file and
    written under `out`; every metric's `workloads` names the twins."""
    from bench_port import harness

    source = source or harness.Layout()
    files = tiny_files(bench, tiny_dir)
    rename = {cell: f["twin"] for cell, f in files.items()}
    configs, workloads = [], []
    for w in bench["workloads"]:
        f, name = files[w["name"]], rename[w["name"]]
        file = pathlib.Path(harness.config_entry(bench, w["config"])["file"])
        cfg = harness.load_json(file if file.is_absolute() else REPO / file)
        configs.append({"name": name, "file": str(write(out / "configs" / f"{name}.json",
                                                        merge_patch(cfg, f.get("config"))))})
        tr = harness.load_json(source.traffic / f"{w['traffic']}.json")
        write(out / "traffic" / f"{name}.json", merge_patch(tr, f.get("traffic")))
        lim = harness.load_json(source.limits / f"{w['name']}.json")
        write(out / "limits" / f"{name}.json", merge_patch(lim, f.get("limits")))
        workloads.append({"name": name, "config": name, "traffic": name, "chips": w["chips"]})
    twin = {**bench, "configs": configs, "workloads": workloads}
    for group in ("end_to_end", "per_layer"):
        twin[group] = [dict(m) for m in bench[group]]
        for m in twin[group]:
            if "workloads" in m:
                m["workloads"] = [rename[w] for w in m["workloads"]]
    return twin, harness.Layout(traffic=out / "traffic", limits=out / "limits",
                                metrics=source.metrics)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(bench, layout) of every cell's tiny twin (`tiny/<cell>.json`), e.g.
    `tiny.batch` (a V = 50 trigram task, 2 batches of 6 sentences) and
    `tiny.fe` (8 mics, 0.25-s blocks, groups of 2), with the real cells'
    limits."""
    d = tmp_path_factory.mktemp("tiny")
    os.environ["DSR_TPU_TORCH_CACHE"] = str(d / "graphs")
    return twins(load("../BENCHMARK.json"), d)


def run_tiny(bench, layout, workload, seed=2**31 + 5, seconds=0.3, trace=False):
    """One CPU run of a tiny cell -> (result, checks, info)."""
    import time

    import torch

    from bench_port import harness

    torch.set_num_threads(2)
    return harness.run(bench, workload, seed, seconds, trace, "cpu", time.monotonic(), layout)
