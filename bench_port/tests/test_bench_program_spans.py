"""The port's own spans (`dsr_tpu_torch/utils/profiling.scope`) in the
benchmark's traced phase: `trace.reduce` names an idle gap by the
innermost of them, and the profiled phase of each tiny cell on the CPU
carries them in its profiler trace, nested inside the benchmark's
spans."""

import json

import pytest

from bench_port import trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_gaps_are_named_by_the_innermost_program_span():
    events = [
        ev("bench.traced", "user_annotation", 0, 100),
        ev("bench.decode_batch", "user_annotation", 0, 100),
        ev("decoder.batch", "user_annotation", 1, 99),
        ev("decoder.frame_loop", "user_annotation", 2, 38),
        ev("decoder.traceback", "user_annotation", 40, 60),
        ev("decoder.traceback.copy", "user_annotation", 40, 30),
        ev("decoder.traceback.walk", "user_annotation", 70, 28),
        ev("void select_kernel<false>(float const*, int)", "kernel", 10, 30),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 45, 25),
        ev("decoder.frame_loop", "gpu_user_annotation", 10, 30),
        ev("cudaMemcpyAsync", "cuda_runtime", 41, 30),
    ]
    p = trace.reduce(events)
    assert p.busy_s == pytest.approx(55e-6)
    assert p.idle_gaps[0] == ["decoder.traceback.walk: python", pytest.approx(30e-6)]
    assert dict(p.idle_gaps) == {"decoder.traceback.walk: python": pytest.approx(30e-6),
                                 "decoder.frame_loop: python": pytest.approx(10e-6),
                                 "decoder.traceback.copy: cudaMemcpyAsync": pytest.approx(5e-6)}


PROGRAM_SPANS = {
    "tiny.batch": ("bench.decode_batch", {"decoder.batch", "decoder.frame_loop",
                                          "decoder.traceback", "decoder.traceback.copy",
                                          "decoder.traceback.walk"}),
    "tiny.fe": (None, {"beamforming.steering_vectors", "beamforming.mvdr_weights",
                       "filterbank.analysis_beamform", "filterbank.synthesis",
                       "features.mfcc", "features.cmn", "gmm.loglik"}),
}


@pytest.mark.parametrize("workload", sorted(PROGRAM_SPANS))
def test_the_profiled_phase_carries_the_program_spans(tiny, workload, tmp_path):
    """The cell's profiled phase (`Cell.trace`) on the CPU, as `harness.run`
    calls it with --trace 1 (its window's CUDA events need a card)."""
    import torch

    from bench_port import harness
    from dsr_tpu_torch.utils import profiling

    bench, layout = tiny
    torch.set_num_threads(2)
    cell = harness.Cell.find(bench, workload, layout)
    run = cell.system.Cell(cell.system.Model(cell.config, "cpu"), cell.traffic, cell.limits,
                           2**31 + 9)
    run.warm()
    path = tmp_path / f"{workload}.json"
    profile = run.trace(lambda fn: trace.profiled(fn, str(path)))
    assert profile.window_s > 0 and profile.idle_gaps
    assert not profiling.is_recording()
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    outer_name, names = PROGRAM_SPANS[workload]
    got = [e for e in spans if e["name"] in names]
    assert {e["name"] for e in got} == names
    outers = [e for e in spans if e["name"] == (outer_name or trace.WINDOW_SPAN)]
    for e in got:
        assert any(o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
                   for o in outers), e["name"]
