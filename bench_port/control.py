"""Readings for the limits of a cell's comparison: the program's, and the
control's (the plain reference a step below the configuration's
precision, in the program's place), on many seeds in one process.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 --seconds 3

For each seed: the cell's pool, a short window at the cell's own load
(every answer it compares comes from it, as in a run), the comparison of
the window's answers with the reference, then the control's answers to
the same requests compared the same way.  Prints one JSON line a seed
and, last, each number's largest program reading and smallest control
reading.  The benchmark's runs never run this; the limits in
`limits/<cell>.json` were set from its readings (PERF.md).
"""

import argparse
import json
import os
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent


def readings(bench, workload, seeds, seconds, device, layout=None):
    """-> [(seed, {name: program value}, {name: control value})]."""
    import torch

    from bench_port import harness

    cell = harness.Cell.find(bench, workload, layout or harness.Layout())
    model = cell.system.Model(cell.config, device)
    out = []
    for seed in seeds:
        run = cell.system.Cell(model, cell.traffic, cell.limits, seed)
        run.warm()
        run.serve(seconds)
        prog = {n: v for n, v, _ in run.check()}
        ctl = {n: v for n, v, _ in run.check(control=True)}
        out.append((seed, prog, ctl))
        del run
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description="Program and control readings of a cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    sys.path[:] = [str(REPO)] + [p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
    os.environ["DSR_TPU_TORCH_CACHE"] = str(HERE / "cache" / "graphs")
    import torch

    from bench_port import harness

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 3
    bench = harness.load_json(REPO / "BENCHMARK.json")
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = readings(bench, args.workload, seeds, args.seconds, "cuda")
    for seed, prog, ctl in rows:
        print(json.dumps({"seed": seed, "program": prog, "control": ctl}))
    names = rows[0][1].keys()
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "program_max": {n: max(r[1][n] for r in rows) for n in names},
                      "control_min": {n: min(r[2][n] for r in rows) for n in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
