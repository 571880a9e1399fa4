"""Run one cell of the port's benchmark once, on the card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: loads the cell's files (see `harness.py`),
sets up and warms up, measures for `--seconds`, checks the answers
against the plain reference, and prints one JSON line last on standard
output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device` (with --trace 1 also `busy_s` and `window_s`), with --trace 1
`breakdown`, and last `checks`: each number compared and its limit, which
also end standard error.  Exits non-zero, printing no result, without a
CUDA card or with fewer than the cell asks for, and when the process has
loaded JAX or the JAX package.

The graphs the port builds are kept in `bench_port/cache/` and the
profiler's trace in `bench_port/traces/`, both inside the checkout.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent


def main() -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path[:] = [str(REPO)] + [p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
    os.environ["DSR_TPU_TORCH_CACHE"] = str(HERE / "cache" / "graphs")

    import torch

    from bench_port import harness

    bench = harness.load_json(REPO / "BENCHMARK.json")
    chips = harness.cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell {args.workload} needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(f"run.py: {args.workload} seed {args.seed} on {smi[:1]}", file=sys.stderr)
    result, checks, info = harness.run(bench, args.workload, args.seed, args.seconds,
                                       bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: the process loaded {found}; the port may not", file=sys.stderr)
        return 4
    print(f"run.py: {json.dumps(info)}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
