"""BENCHMARK.json keeps the benchmark's contract, every name it uses has
its file, and a run's last line has the keys the contract asks for."""

import json
import re

import pytest

from conftest import BENCH, REPO, run_tiny, tiny_files, twin_names

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def bench():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench_port"]
    assert bench["command"] == ["python3", "bench_port/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_configs_and_cells(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("bench_port/") and (REPO / c["file"]).exists()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in names and LINE.match(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    assert {w["config"] for w in bench["workloads"]} == set(names)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    seen = set()
    for group, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in bench[group]:
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in seen
            seen.add(m["name"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in (SOURCES_E2E if group == "end_to_end" else SOURCES)
            assert set(m.get("workloads", cells)) <= cells
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()
            if group == "end_to_end":
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert LINE.match(m["layer"]) and m["moves"] in e2e
                reporting = set(e2e[m["moves"]].get("workloads", cells))
                assert set(m.get("workloads", reporting)) <= reporting
    assert e2e["setup_s"]["bound"] <= 0.25
    for cell in cells:
        mine = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])


def test_files_are_named_as_names():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(REPO).as_posix()
        assert len(rel) <= 200 and re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
        assert all(NAME.match(part) for part in p.relative_to(REPO).parts), rel


def test_every_cell_has_one_tiny_twin(bench):
    """Each cell has `tests/tiny/<cell>.json` (the fixture names no cell),
    each tiny file is a cell's, twins' names are unique and no cell's, and
    every name a metric's `workloads` lists maps to a twin."""
    files = tiny_files(bench)
    names = [f["twin"] for f in files.values()]
    assert len(set(names)) == len(names) and not set(names) & set(files)
    assert sorted(names) == twin_names()
    for f in files.values():
        assert NAME.match(f["twin"]) and set(f) <= {"twin", "config", "traffic", "limits"}
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            assert all(w in files for w in m.get("workloads", [])), m["name"]


@pytest.mark.parametrize("workload", twin_names())
def test_last_line_schema(tiny, workload):
    bench, layout = tiny
    result, checks, info = run_tiny(bench, layout, workload)
    assert set(result) == {"correct", "attempted", "failed", "metrics", "device"}
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    want = {m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
    assert set(result["metrics"]) == want
    for v in result["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert checks and all(v <= lim for _, v, lim in checks)
    json.dumps(result)
