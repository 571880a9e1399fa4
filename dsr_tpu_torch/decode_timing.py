"""Time the batched decodes alone, in a process of their own, on the card.

The bench graph (V = 2000 trigram HCLG, as chip_smoke.py builds it) is
decoded at bench.py's shape (8 utterances x 1000 frames, kcap 256, beam
40; the split decoder with a0 = 2, eg = 896) from log-likelihoods made
from a seed; each decode is timed by CUDA events around it, traceback
included, and printed as seconds and audio-seconds per second.  With
`--profile` one more split decode runs under cProfile and the host
functions that take the most time are printed.

    python3 dsr_tpu_torch/decode_timing.py [--root TREE] [--reps N] [--profile]

`--root` times the `dsr_tpu_torch` package of another checkout (for
example a parent commit's, to compare two trees in one session); the
default is the checkout this file is in.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import subprocess
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [os.path.abspath(args.root)] + [p for p in sys.path if os.path.abspath(p or ".") != here]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_timing: no CUDA device is available; this script runs on the card",
              file=sys.stderr)
        return 2
    from dsr_tpu_torch.asr import lvcsr
    from dsr_tpu_torch.asr.decoder import split_decoder as sd
    from dsr_tpu_torch.asr.decoder import topk_decoder as tk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="dsr_tpu_torch_graphs_") as cache_dir:
        os.environ["DSR_TPU_TORCH_CACHE"] = cache_dir
        task = lvcsr.build_task(lvcsr.LvcsrConfig())
        sg = sd.build_split_graph(task.graph, a0=2, device=dev)
        tg = tk.build_token_graph(task.graph, device=dev)
    U, T, kcap, beam, eg = 8, 1000, 256, 40.0, 896
    ll = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (U, T, task.num_pdfs)).astype(np.float32), device=dev)
    lens = np.full(U, T)
    audio_s = U * T / 125.0
    decoders = {
        "split": lambda: sd.decode_batch_split(sg, ll, lens, kcap=kcap, beam=beam, eg=eg),
        "dense": lambda: tk.decode_batch(tg, ll, lens, kcap=kcap, beam=beam),
    }
    print(f"decode_timing: dsr_tpu_torch from {os.path.abspath(args.root)}  [{smi}]")
    for name, run in decoders.items():
        run()   # warm-up: the kernels' build and first launches
        secs = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            secs.append(start.elapsed_time(end) / 1e3)
        print(f"decode {name} U={U} T={T} kcap={kcap} beam={beam:g}, {args.reps} runs: "
              + ", ".join(f"{s:.3f} s = {audio_s / s:.1f} audio-s/s" for s in secs)
              + f"; median {audio_s / sorted(secs)[len(secs) // 2]:.1f} audio-s/s  [{smi}]")
    if args.profile:
        prof = cProfile.Profile()
        prof.enable()
        decoders["split"]()
        torch.cuda.synchronize()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(12)
        print("decode split under cProfile (host time by function):")
        print("\n".join(line for line in out.getvalue().splitlines() if line.strip()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
