"""A new traffic mix, cell and metric are new files only: the harness
finds them by name, with no edit to a file it has."""

import shutil
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, TINY, load, run_tiny, twins, write


def test_a_throwaway_mix_and_metric(tiny, tmp_path):
    from bench_port import harness

    bench, layout = tiny
    traffic = tmp_path / "traffic"
    shutil.copytree(layout.traffic, traffic)
    p = load("traffic/batch1024.json")
    p.update(utterances_per_batch=3, pool_batches=1, words=[2, 3], noise=0.3)
    write(traffic / "throwaway_short.json", p)
    limits = tmp_path / "limits"
    shutil.copytree(layout.limits, limits)
    shutil.copy(limits / "tiny.batch.json", limits / "tiny.short.json")
    metrics = tmp_path / "metrics"
    shutil.copytree(BENCH / "metrics", metrics, ignore=shutil.ignore_patterns("__pycache__"))
    (metrics / "frames_per_request.py").write_text(
        '"""Seconds of audio a request."""\n\n\ndef read(ctx):\n'
        '    return ctx.audio_s / len(ctx.latencies_s)\n')
    new = {**bench,
           "workloads": bench["workloads"] + [{"name": "tiny.short", "config": "tiny.batch",
                                               "traffic": "throwaway_short", "chips": 1}],
           "end_to_end": bench["end_to_end"] + [{"name": "frames_per_request", "unit": "s",
                                                 "workloads": ["tiny.short"]}]}
    lay = harness.Layout(traffic=traffic, limits=limits, metrics=metrics)
    result, checks, _ = run_tiny(new, lay, "tiny.short")
    assert result["correct"] is True
    assert 0 < result["metrics"]["frames_per_request"]["value"] < 2.0   # 2-3 words a request
    assert result["attempted"] % 3 == 0


class _HostEvent:
    """`torch.cuda.Event` on the host clock, for a traced run on the CPU."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_a_throwaway_cell_joins_through_files_alone(tiny, tmp_path, monkeypatch):
    """A new cell on a new mix, with its limits file, its tiny file and a
    per-layer metric that lists only it, all written beside copies of the
    benchmark's files: the fixture's layout is built from the changed
    BENCHMARK.json, and the new twin runs correct and reports its metric."""
    from bench_port import harness, trace

    real = load("../BENCHMARK.json")
    src = harness.Layout(traffic=tmp_path / "traffic", limits=tmp_path / "limits",
                         metrics=tmp_path / "metrics")
    for folder in ("traffic", "limits", "metrics"):
        shutil.copytree(BENCH / folder, tmp_path / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    tiny_dir = tmp_path / "tiny"
    shutil.copytree(TINY, tiny_dir)
    mix = load("traffic/batch1024.json")
    mix.update(words=[2, 3], noise=0.3)
    write(src.traffic / "throwaway_short.json", mix)
    write(src.limits / "v2k.short.json", load("limits/v2k.batch.json"))
    patch = load("tests/tiny/v2k.batch.json")
    write(tiny_dir / "v2k.short.json", {**patch, "twin": "tiny.short",
                                        "traffic": {"utterances_per_batch": 3,
                                                    "pool_batches": 1}})
    (src.metrics / "throwaway_s_per_request.py").write_text(
        '"""Seconds of audio a request."""\n\n\ndef read(ctx):\n'
        '    return ctx.audio_s / len(ctx.latencies_s)\n')
    bench = {**real,
             "workloads": real["workloads"] + [{
                 "name": "v2k.short", "config": "lvcsr_v2000", "traffic": "throwaway_short",
                 "chips": 1, "why": "2-3 word utterances, 3 a batch"}],
             "per_layer": real["per_layer"] + [{
                 "name": "throwaway_s_per_request", "unit": "s", "better": "higher",
                 "source": "host_clock", "layer": "decoder: asr/decoder/topk_decoder",
                 "moves": "audio_s_per_s", "workloads": ["v2k.short"]}]}
    twin, layout = twins(bench, tmp_path / "twins", tiny_dir, src)
    assert [m["workloads"] for m in twin["per_layer"]][-1] == ["tiny.short"]
    profiled = trace.profiled
    monkeypatch.setattr(trace, "profiled",
                        lambda fn, path: profiled(fn, str(tmp_path / "short.json")))
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)       # the window's spans, on the CPU
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    result, checks, _ = run_tiny(twin, layout, "tiny.short", trace=True)
    assert result["correct"] is True, checks
    assert set(result["metrics"]) == {"throwaway_s_per_request"}
    assert 0 < result["metrics"]["throwaway_s_per_request"]["value"] < 2.0
    assert result["attempted"] % 3 == 0


def test_a_cell_without_a_tiny_file_names_the_file_to_add(tmp_path):
    real = load("../BENCHMARK.json")
    bench = {**real, "workloads": real["workloads"] + [
        {"name": "v2k.missing", "config": "lvcsr_v2000", "traffic": "batch1024", "chips": 1}]}
    with pytest.raises(FileNotFoundError, match=r"tiny/v2k\.missing\.json"):
        twins(bench, tmp_path)


def test_a_graph_other_than_the_configurations_is_refused(tiny):
    """The decode configuration pins its graph's arcs by a fingerprint; a
    graph the port's compiler builds otherwise stops the run at set-up."""
    from bench_port import harness

    bench, layout = tiny
    cell = harness.Cell.find(bench, "tiny.batch", layout)
    g = cell.system.Model(cell.config, "cpu").task.graph
    from bench_port.reference.lvcsr_decode import graph_digest

    good = {"num_states": g.num_states, "num_arcs": g.num_arcs,
            "a_max": int(np.bincount(g.src).max()),
            "arcs_sha256": graph_digest(g.src, g.pdf, g.olabel, g.weight, g.dst, g.start,
                                        g.final_weight, g.num_states)}
    cell.system.Model({**cell.config, "expect": good}, "cpu")
    w = np.array(g.weight, np.float32)
    w[len(w) // 2] += 0.5
    other = graph_digest(g.src, g.pdf, g.olabel, w, g.dst, g.start, g.final_weight, g.num_states)
    assert other != good["arcs_sha256"]
    with pytest.raises(RuntimeError, match="configuration states"):
        cell.system.Model({**cell.config, "expect": {**good, "arcs_sha256": other}}, "cpu")
