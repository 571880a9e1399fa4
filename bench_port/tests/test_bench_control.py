"""The control -- the plain reference a step below the configuration's
float32, in the program's place -- fails each cell's limits, while the
program passes them: at a tiny size on the CPU, and (marked `chip`) at
the cells' own sizes on the card, three seeds each."""

import json

import pytest

from conftest import BENCH, REPO, twin_names


def fails(values: dict, limits: dict) -> list:
    return [n for n, v in values.items() if v > limits[n]]


@pytest.mark.parametrize("workload", twin_names())
def test_control_fails_at_a_tiny_size(tiny, workload):
    from bench_port import control, harness

    bench, layout = tiny
    limits = harness.load_json(layout.limits / f"{workload}.json")["limits"]
    for seed, prog, ctl in control.readings(bench, workload, [2**31 + 1, 9], 0.3, "cpu", layout):
        assert not fails(prog, limits), (seed, prog)
        assert fails(ctl, limits), (seed, ctl)


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["v2k.batch", "v2k.noisy", "mvdr64.block8s"])
def test_control_fails_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench_port import control, harness

    bench = harness.load_json(REPO / "BENCHMARK.json")
    limits = harness.load_json(BENCH / "limits" / f"{workload}.json")["limits"]
    for seed, prog, ctl in control.readings(bench, workload, [2**31 + 21, 22, 23], 3.0, "cuda"):
        assert not fails(prog, limits), json.dumps(prog)
        assert fails(ctl, limits), json.dumps(ctl)
