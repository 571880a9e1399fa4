"""The profiler trace's reduction: busy time as a union, kernels by short
name, idle gaps named by what the host was doing."""

import pytest

from bench_port import trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("bench.traced", "user_annotation", 0, 100),
    ev("bench.decode_batch", "user_annotation", 0, 100),
    ev("void select_kernel<false>(float const*, int)", "kernel", 10, 20),
    ev("void at::native::elementwise_kernel<128, 4>(int)", "kernel", 20, 20),
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 60, 10),
    ev("void select_kernel<false>(float const*, int)", "kernel", 90, 30),
    ev("bench.decode_batch", "gpu_user_annotation", 0, 100),
    ev("aten::copy_", "cpu_op", 45, 10),
    ev("cudaStreamSynchronize", "cuda_runtime", 75, 10),
]


def test_reduce():
    p = trace.reduce(EVENTS)
    assert p.window_s == pytest.approx(100e-6)
    assert p.busy_s == pytest.approx(50e-6)       # [10, 40] + [60, 70] + [90, 100]
    assert p.kernels["select_kernel"] == [pytest.approx(20e-6), 1]   # the last one ends outside
    assert p.kernel_seconds("select_kernel", "keys_kernel") == pytest.approx(20e-6)
    assert p.kernels["at::native::elementwise_kernel"] == [pytest.approx(20e-6), 1]
    gaps = dict(p.idle_gaps)
    assert gaps == {"bench.decode_batch: python": pytest.approx(10e-6),
                    "bench.decode_batch: aten::copy_": pytest.approx(20e-6),
                    "bench.decode_batch: cudaStreamSynchronize": pytest.approx(20e-6)}
    assert p.device_ops[0][1] >= p.device_ops[-1][1]


def test_reduce_without_the_host_span():
    """A device-only trace: the window is the first to the last device event."""
    p = trace.reduce([e for e in EVENTS if e["cat"] != "user_annotation"])
    assert p.window_s == pytest.approx(110e-6)     # [10, 120]
    assert p.busy_s == pytest.approx(70e-6)        # [10, 40] + [60, 70] + [90, 120]
    assert p.kernels["select_kernel"] == [pytest.approx(50e-6), 2]
    with pytest.raises(ValueError):
        trace.reduce([e for e in EVENTS if e["cat"] in ("cpu_op", "cuda_runtime")])


def test_short_name():
    assert trace.short_name("void analysis_beamform_kernel<true, 8>(float const*)") == \
        "analysis_beamform_kernel"
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
