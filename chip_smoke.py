#!/usr/bin/env python3
"""Drive the PyTorch/CUDA front end (`dsr_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:
  1. environment (torch, CUDA, nvcc, card name and power limit), then the
     build of every CUDA kernel from the sources in this checkout;
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes and at a D = 256 config, with the time of each;
  3. the main path: `DsrPipeline.process` (MVDR) on 4 requests of
     8 ch x 4 s with GMM scoring, the `entry` forward, and the serving
     beamform (fused analysis+beamform -> synthesis) at 64 ch x 8 s; the
     launch counters are set to 0 just before each of these paths and read
     just after it, and each path must launch exactly its kernels;
  4. the outputs: finite, card == CPU plain path on the same request,
     `entry` == its plain composition on the card, DS reconstruction
     < -50 dB; then the serving beamform's audio-seconds per second.
The last two lines are the kernels' JSON record and the verdict
`{"ok": true, "device": {...}}`.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SR = 16000.0
SOURCE = np.array([0.0, 2.0, 0.0])
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, FP32 outside the tensor cores
TOL = 1e-5                     # max |kernel - plain| / max |plain|, as tests/test_pallas.py
SPIN_CYCLES = 40_000_000       # GPU clock cycles the card waits before a timed loop


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).abs().max() / ref.abs().max())


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls, by
    CUDA events.  The card first spins (about 20 ms) while the host queues
    every call, so host launch overhead does not show between the calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rfft_flops(n: int) -> float:
    """Operations of a real-input FFT of length n: half the 5 n log2 n of a
    complex one.  The least arithmetic a length-n real DFT needs, whatever
    way a kernel computes it."""
    return 2.5 * n * math.log2(n)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least milliseconds for the work at the card's peaks, and which bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dsr_tpu_torch.asr.am import gmm
    from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
    from dsr_tpu_torch.entry import entry
    from dsr_tpu_torch.ops import beamforming as bf
    from dsr_tpu_torch.ops import features as ft
    from dsr_tpu_torch.ops import filterbank as fb
    from dsr_tpu_torch.ops.cuda import build
    from dsr_tpu_torch.ops.cuda import filterbank as cfb
    from dsr_tpu_torch.pipeline import DsrPipeline

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. environment and build ------------------------------------------
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"CUDA {torch.version.cuda}")
    nvcc = build.nvcc()
    print(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    path, log = build.build()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"    {line.strip()}")

    cfg = FilterbankConfig(M=256, m=4, r=2)
    cfg_d256 = FilterbankConfig(M=512, m=4, r=2)
    hf, gf, delay = fb.get_prototypes(cfg)
    hf_t = torch.as_tensor(np.asarray(hf, np.float32), device=dev)
    gf_t = torch.as_tensor(np.asarray(gf, np.float32), device=dev)
    rng = np.random.default_rng(0)
    hf2 = torch.as_tensor(rng.standard_normal(cfg_d256.L).astype(np.float32) / 16, device=dev)
    gf2 = torch.as_tensor(rng.standard_normal(cfg_d256.L).astype(np.float32) / 16, device=dev)

    def signal(C, seconds):
        return torch.as_tensor(rng.standard_normal((C, int(SR * seconds))).astype(np.float32),
                               device=dev)

    # ---- 2. kernels against their plain versions ---------------------------
    record = {}

    def compare(name, label, kernel, plain, nbytes, flops, library=None):
        out = kernel()
        ref = plain()
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        lib_ms = cuda_ms(library) if library is not None else None
        b_ms, b_by = bound(nbytes, flops)
        print(f"{name:18s} {label:34s} rel err {err:.2e} (bound {TOL:.0e})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound {b_ms:.4f} ms "
              f"({b_by})  [{smi}]")
        check(err <= TOL, f"{name} {label}: rel err {err:.3e} > {TOL}")
        return dict(max_abs_err=float((out - ref).abs().max()), rel_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    def analysis_case(c, x, h, label, main):
        C, S = x.shape
        T = fb.num_frames(S, c)
        K = c.num_bins
        P = c.L - c.D
        xp = torch.nn.functional.pad(x, (P, (T - 1) * c.D + c.L - P - S))

        def stft():  # L/2+1 bins at n_fft = L, of which every m-th is A
            return torch.stft(xp, c.L, c.D, window=h, center=False, return_complex=True)

        ref = cfb.analysis_plain(x, h, c.M, c.r, T)
        check(rel_err(stft()[:, ::c.m, :].transpose(1, 2), ref) <= TOL,
              "torch.stft yardstick computes the analysis")
        res = compare("analysis", label, lambda: cfb.analysis(x, h, c.M, c.m, c.r, T),
                      lambda: cfb.analysis_plain(x, h, c.M, c.r, T),
                      4 * (C * S + c.L) + 8 * C * T * K,
                      C * T * (2 * c.L + rfft_flops(c.M)), library=stft)
        if main:
            record["analysis"] = res

    def synthesis_case(c, A, g, out_len, label, main):
        C, T, K = A.shape
        start = c.L - c.D
        res = compare("synthesis", label,
                      lambda: cfb.synthesis(A, g, c.M, c.m, c.r, start, out_len),
                      lambda: cfb.synthesis_plain(A, g, c.M, c.r, start, out_len),
                      8 * C * T * K + 4 * c.L + 4 * C * out_len,
                      C * (T * rfft_flops(c.M) + out_len * 2 * (c.L // c.D)))
        if main:
            record["synthesis"] = res

    x_req = signal(8, 4.0)
    analysis_case(cfg, x_req, hf_t, "8 ch x 4 s M=256 m=4 r=2", True)
    analysis_case(cfg, signal(8, 1.0), hf_t, "8 ch x 1 s M=256 m=4 r=2", False)
    x_d256 = signal(8, 1.0)
    analysis_case(cfg_d256, x_d256, hf2, "8 ch x 1 s M=512 m=4 r=2 (D=256)", False)

    pipe64 = DsrPipeline(fb=cfg, geometry=ArrayGeometry.circular(64, 0.20),
                         beamformer=BeamformerConfig(kind="mvdr"))
    w64 = pipe64.weights(SOURCE).contiguous()
    x64 = signal(64, 8.0)
    S64 = x64.shape[-1]
    T64 = fb.num_frames(S64, cfg)
    K = cfg.num_bins
    record["analysis_beamform"] = compare(
        "analysis_beamform", "64 ch x 8 s MVDR M=256 m=4 r=2",
        lambda: cfb.analysis_beamform(x64, hf_t, w64, cfg.M, cfg.m, cfg.r, T64),
        lambda: cfb.analysis_beamform_plain(x64, hf_t, w64, cfg.M, cfg.r, T64),
        4 * (64 * S64 + cfg.L) + 8 * K * 64 + 8 * T64 * K,
        64 * T64 * (2 * cfg.L + rfft_flops(cfg.M) + 8 * K))

    Y64 = cfb.analysis_beamform_plain(x64, hf_t, w64, cfg.M, cfg.r, T64)[None].contiguous()
    synthesis_case(cfg, Y64, gf_t, S64, "1 ch x 8 s (serving output)", True)
    A_req = cfb.analysis_plain(x_req, hf_t, cfg.M, cfg.r, fb.num_frames(x_req.shape[-1], cfg))
    synthesis_case(cfg, A_req, gf_t, x_req.shape[-1], "8 ch x 4 s", False)
    A_d256 = cfb.analysis_plain(x_d256, hf2, cfg_d256.M, cfg_d256.r,
                                fb.num_frames(x_d256.shape[-1], cfg_d256))
    synthesis_case(cfg_d256, A_d256, gf2, x_d256.shape[-1], "8 ch x 1 s M=512 (D=256)", False)

    # every kernel at every shipped config and a D = 256 one (no timing)
    for c, h, g in [(FilterbankConfig(M=M, m=m, r=r, joint_iters=j), None, None)
                    for M, m, r, j in ((64, 2, 2, 2), (64, 4, 1, 6), (64, 4, 2, 2),
                                       (96, 2, 2, 2))] + [(cfg_d256, hf2, gf2)]:
        if h is None:
            h, g, _ = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                       for a in fb.get_prototypes(c))
        xs = signal(3, 0.5)
        T = fb.num_frames(xs.shape[-1], c)
        ws = torch.as_tensor(rng.standard_normal((c.num_bins, 3, 2)).astype(np.float32),
                             device=dev)
        ws = torch.view_as_complex(ws).contiguous()
        A = cfb.analysis(xs, h, c.M, c.m, c.r, T)
        errs = (rel_err(A, cfb.analysis_plain(xs, h, c.M, c.r, T)),
                rel_err(cfb.analysis_beamform(xs, h, ws, c.M, c.m, c.r, T),
                        cfb.analysis_beamform_plain(xs, h, ws, c.M, c.r, T)),
                rel_err(cfb.synthesis(A, g, c.M, c.m, c.r, c.L - c.D + 5, xs.shape[-1]),
                        cfb.synthesis_plain(A, g, c.M, c.r, c.L - c.D + 5, xs.shape[-1])))
        print(f"M={c.M} m={c.m} r={c.r}: analysis / analysis_beamform / synthesis rel err "
              + " / ".join(f"{e:.2e}" for e in errs))
        check(max(errs) <= TOL, f"kernels at M={c.M} m={c.m} r={c.r}")

    # ---- 3. the main path, counted -----------------------------------------
    pipe = DsrPipeline(fb=cfg, geometry=ArrayGeometry.circular(8, 0.10),
                       beamformer=BeamformerConfig(kind="mvdr"))
    S_states, C_comp, D_feat = 128, 16, 13
    params = gmm.GmmParams(rng.standard_normal((S_states, C_comp, D_feat)),
                           0.5 + rng.random((S_states, C_comp, D_feat)),
                           np.log(np.full((S_states, C_comp), 1.0 / C_comp))).to(dev)
    requests = [rng.standard_normal((8, int(4 * SR))).astype(np.float32) for _ in range(4)]
    fwd, (x_entry,) = entry()
    torch.cuda.synchronize()

    counts = dict.fromkeys(cfb.launches, 0)

    def counted(path, fn, expect):
        """fn() with the launch counters set to 0 just before it and read just
        after; the path must have launched exactly `expect` of each kernel."""
        cfb.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(cfb.launches)
        print(f"launches on path {path}: {got}")
        check(got == expect, f"path {path} launched {got}, expected {expect}")
        for name, n in got.items():
            counts[name] += n
        return out

    def process_and_score(x):
        y, feats = pipe.process(x, SOURCE)
        return y, feats, gmm.loglik(params, feats)

    def serve_once():
        Y = fb.analysis_beamform(x64, w64, cfg, hf_t)
        return fb.synthesis(Y, cfg, S64, gf_t, delay)

    outs = [counted(f"process[{i}]", lambda: process_and_score(x),
                    {"analysis": 1, "analysis_beamform": 0, "synthesis": 1})
            for i, x in enumerate(requests)]
    ll_entry = counted("entry", lambda: fwd(x_entry),
                       {"analysis": 1, "analysis_beamform": 0, "synthesis": 0})
    y_srv = counted("serving", serve_once,
                    {"analysis": 0, "analysis_beamform": 1, "synthesis": 1})
    print(f"main path launches, all paths: {counts}")

    # ---- 4. outputs ---------------------------------------------------------
    for y, feats, ll in outs:
        check(y.shape == (int(4 * SR),) and feats.shape[-1] == 13
              and ll.shape == (feats.shape[0], S_states), "output shapes")
        check(bool(torch.isfinite(y).all() and torch.isfinite(feats).all()
                   and torch.isfinite(ll).all()), "finite process outputs")
    check(bool(torch.isfinite(ll_entry).all() and torch.isfinite(y_srv).all()),
          "finite entry and serving outputs")

    cpu = DsrPipeline(fb=cfg, geometry=ArrayGeometry.circular(8, 0.10),
                      beamformer=BeamformerConfig(kind="mvdr"), device="cpu")
    y_cpu, feats_cpu = cpu.process(requests[0], SOURCE)
    e_y = rel_err(outs[0][0].cpu(), y_cpu)
    e_f = rel_err(outs[0][1].cpu(), feats_cpu)
    print(f"process card vs CPU plain path: waveform rel err {e_y:.2e}, features {e_f:.2e}")
    # Both go through the MVDR weights, whose complex64 inverse of Γ + 1e-2·I
    # is ill-conditioned at the low bins (condition number ~8e2 at DC), so
    # the card's and the CPU's libraries agree to ~cond·eps: 1e-4, as the
    # CPU parity tests allow for MVDR outputs.
    check(e_y <= 1e-4 and e_f <= 1e-4, "process on the card agrees with the CPU plain path")

    T_e = fb.num_frames(x_entry.shape[-1], cfg)
    A_e = cfb.analysis_plain(x_entry, fwd.hf, cfg.M, cfg.r, T_e)
    feats_e = ft.cmn(ft.mfcc_from_subbands(bf.apply_weights(A_e, fwd.w), cfg.M, SR))
    e_ll = rel_err(ll_entry, gmm.loglik(fwd.params, feats_e))
    print(f"entry forward vs its plain composition on the card: rel err {e_ll:.2e}")
    check(e_ll <= 1e-4, "entry forward agrees with the plain functions")

    x_rt = signal(8, 2.0)
    y_rt = fb.synthesis(fb.analysis(x_rt, cfg), cfg, x_rt.shape[-1])
    rt_db = 20 * float(torch.log10((y_rt - x_rt).abs().max() / x_rt.abs().max()))
    print(f"DS analysis -> synthesis reconstruction on the card: {rt_db:.1f} dB (gate < -50)")
    check(rt_db < -50.0, "filterbank reconstruction")

    serve_ms = cuda_ms(serve_once, iters=10)
    print(f"serving beamform 64 ch x 8 s MVDR (fused analysis+beamform -> synthesis): "
          f"{serve_ms:.3f} ms of device time per request = {8.0 / (serve_ms / 1e3):.1f} "
          f"audio-s/s [{smi}]")

    # one process() request (8 ch x 4 s, MVDR) end to end on the host clock,
    # and its stages on the card's clock
    x0 = requests[0]
    reps = 10
    pipe.process(x0, SOURCE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        pipe.process(x0, SOURCE)
    torch.cuda.synchronize()
    proc_ms = (time.perf_counter() - t0) / reps * 1e3
    xt = torch.as_tensor(x0, device=dev)
    A0 = fb.analysis(xt, cfg)
    w0 = pipe.weights(SOURCE)
    Y0 = bf.apply_weights(A0, w0)
    f0 = ft.cmn(ft.mfcc_from_subbands(Y0, cfg.M, SR))
    stages = {
        "upload": lambda: torch.as_tensor(x0, device=dev),
        "analysis": lambda: fb.analysis(xt, cfg),
        "mvdr weights (from the cached inverse)": lambda: pipe.weights(SOURCE),
        "apply weights": lambda: bf.apply_weights(A0, w0),
        "synthesis": lambda: fb.synthesis(Y0, cfg, xt.shape[-1]),
        "mfcc+cmn": lambda: ft.cmn(ft.mfcc_from_subbands(Y0, cfg.M, SR)),
        "gmm loglik (128 x 16)": lambda: gmm.loglik(params, f0),
    }
    parts = {name: cuda_ms(fn, iters=10) for name, fn in stages.items()}
    print(f"process 8 ch x 4 s MVDR: {proc_ms:.3f} ms per request on the host clock = "
          f"{4.0 / (proc_ms / 1e3):.1f} audio-s/s [{smi}]; stages (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))

    kernels = []
    replaces = {"analysis": "dsr_tpu/ops/pallas/filterbank.py:188",
                "analysis_beamform": "dsr_tpu/ops/pallas/filterbank.py:338",
                "synthesis": "dsr_tpu/ops/pallas/filterbank.py:710"}
    for name in ("analysis", "analysis_beamform", "synthesis"):
        r = record[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": "dsr_tpu_torch/ops/cuda/csrc/filterbank.cu",
                        "replaces": replaces[name], "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
