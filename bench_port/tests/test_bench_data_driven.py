"""A new traffic mix, cell and metric are new files only: the harness
finds them by name, with no edit to a file it has."""

import shutil

import numpy as np

from conftest import BENCH, load, run_tiny, write


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
           "workloads": bench["workloads"] + [{"name": "tiny.short", "config": "tiny_lvcsr",
                                               "traffic": "throwaway_short", "chips": 1}],
           "end_to_end": bench["end_to_end"] + [{"name": "frames_per_request", "unit": "s",
                                                 "workloads": ["tiny.short"]}]}
    lay = harness.Layout(traffic=traffic, limits=limits, metrics=metrics)
    result, checks, _ = run_tiny(new, lay, "tiny.short")
    assert result["correct"] is True
    assert 0 < result["metrics"]["frames_per_request"]["value"] < 2.0   # 2-3 words a request
    assert result["attempted"] % 3 == 0


def test_a_graph_other_than_the_configurations_is_refused(tiny):
    """The decode configuration pins its graph's arcs by a fingerprint; a
    graph the port's compiler builds otherwise stops the run at set-up."""
    import pytest

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
