"""Fixtures of the benchmark's CPU tests: a tiny copy of each kind of cell
in a temporary layout, run through the harness on the CPU (the port's
plain paths).  Tests that need the card carry the `chip` marker and skip
here, deciding inside the test."""

import json
import os
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BENCH = REPO / "bench_port"


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


def load(rel: str) -> dict:
    with open(BENCH / rel) as f:
        return json.load(f)


def write(path: pathlib.Path, obj) -> pathlib.Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))
    return path


TINY_LIMITS_DECODE = {"sample": 8, "limits": load("limits/v2k.batch.json")["limits"]}
TINY_LIMITS_FE = {"sample_groups": 2, "limits": load("limits/mvdr64.block8s.json")["limits"]}


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(bench, layout) of two tiny cells: `tiny.batch` (a V = 50 trigram
    task, 2 batches of 6 sentences) and `tiny.fe` (8 mics, 0.25-s blocks,
    groups of 2), with the real cells' limits."""
    from bench_port import harness

    d = tmp_path_factory.mktemp("tiny")
    os.environ["DSR_TPU_TORCH_CACHE"] = str(d / "graphs")
    cfg = load("configs/lvcsr_v2000.json")
    cfg["lvcsr"] = {"vocab_size": 50, "n_tokens": 1000, "branching": 3, "order": 3,
                    "states_per_phone": 3, "seed": 0}
    del cfg["expect"]
    fcfg = load("configs/mvdr64_m256.json")
    fcfg["array"]["channels"] = 8
    tr = load("traffic/batch1024.json")
    tr.update(utterances_per_batch=6, pool_batches=2)
    ftr = load("traffic/block8s.json")
    ftr.update(block_s=0.25, pool_blocks=4, group=2, trace_groups=2)
    write(d / "traffic/tiny_batch.json", tr)
    write(d / "traffic/tiny_blocks.json", ftr)
    write(d / "limits/tiny.batch.json", TINY_LIMITS_DECODE)
    write(d / "limits/tiny.fe.json", TINY_LIMITS_FE)
    real = load("../BENCHMARK.json")
    bench = {**real,
             "configs": [{"name": "tiny_lvcsr", "file": str(write(d / "configs/tiny_lvcsr.json", cfg))},
                         {"name": "tiny_fe", "file": str(write(d / "configs/tiny_fe.json", fcfg))}],
             "workloads": [{"name": "tiny.batch", "config": "tiny_lvcsr", "traffic": "tiny_batch",
                            "chips": 1},
                           {"name": "tiny.fe", "config": "tiny_fe", "traffic": "tiny_blocks",
                            "chips": 1}]}
    for group in ("end_to_end", "per_layer"):
        bench[group] = [dict(m) for m in real[group]]
        for m in bench[group]:
            if "workloads" in m:
                m["workloads"] = [{"v2k.batch": "tiny.batch", "v2k.noisy": "tiny.batch",
                                   "mvdr64.block8s": "tiny.fe"}[w] for w in m["workloads"]]
                m["workloads"] = sorted(set(m["workloads"]))
    layout = harness.Layout(traffic=d / "traffic", limits=d / "limits")
    return bench, layout


def run_tiny(bench, layout, workload, seed=2**31 + 5, seconds=0.3):
    """One CPU run of a tiny cell -> (result, checks, info)."""
    import time

    import torch

    from bench_port import harness

    torch.set_num_threads(2)
    return harness.run(bench, workload, seed, seconds, False, "cpu", time.monotonic(), layout)
