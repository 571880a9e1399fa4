#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dsr_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:
  1. environment (torch, CUDA, nvcc, card name and power limit), then the
     builds, all started together, of every native source in this checkout
     (the CUDA kernels with nvcc, the WFST core with g++), each timed;
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes and at a D = 256 config, with the time of each;
     the select kernel at the decoders' four pool shapes, bitwise;
  3. the front end's main path: `DsrPipeline.process` (MVDR) on 4 requests
     of 8 ch x 4 s with GMM scoring, the `entry` forward, and the serving
     beamform (fused analysis+beamform -> synthesis) at 64 ch x 8 s; the
     launch counters are set to 0 just before each path and read just
     after it, and each path must launch exactly its kernels;
  4. the outputs: finite, card == CPU plain path on the same request,
     `entry` == its plain composition on the card, DS reconstruction
     < -50 dB; then the serving beamform's audio-seconds per second;
  5. the decode: the bench graph (V = 2000 trigram HCLG) built by the
     port's own WFST core, the degree-split (a0 = 2, eg = 896) and dense
     batched decodes at bench.py's shape (8 x 1000 frames, kcap 256, beam
     40) with exactly 1000 select launches each and their audio-seconds
     per second; the card's tokens and words against the CPU plain path's
     (utterances 0-1, frames 0-199, bitwise); the in-domain 0-WER gate on
     the V = 300 graph for both decoders; and the streaming recogniser
     (front end + chunked decode) against the offline decode.
The last two lines are the kernels' JSON record and the verdict
`{"ok": true, "device": {...}}`.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SR = 16000.0
SOURCE = np.array([0.0, 2.0, 0.0])
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, FP32 outside the tensor cores
TOL = 1e-5                     # max |kernel - plain| / max |plain|, as tests/test_pallas.py
SPIN_CYCLES = 40_000_000       # GPU clock cycles the card waits before a timed loop
NEG = -1e30                    # the decoders' dead score


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
    from dsr_tpu_torch.asr import lvcsr
    from dsr_tpu_torch.asr.am import gmm
    from dsr_tpu_torch.asr.decoder import split_decoder as sd
    from dsr_tpu_torch.asr.decoder import topk_decoder as tk
    from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
    from dsr_tpu_torch.entry import entry
    from dsr_tpu_torch.ops import beamforming as bf
    from dsr_tpu_torch.ops import features as ft
    from dsr_tpu_torch.ops import filterbank as fb
    from dsr_tpu_torch.ops.cuda import build
    from dsr_tpu_torch.ops.cuda import filterbank as cfb
    from dsr_tpu_torch.ops.cuda import select as csel
    from dsr_tpu_torch.pipeline import DsrPipeline, StreamingRecognizer

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
    def timed_build(name):
        t0 = time.perf_counter()
        path, log = build.build(name)
        return path, log, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(build.SOURCES)) as pool:
        builds = {name: pool.submit(timed_build, name) for name in build.SOURCES}
        for name, fut in builds.items():
            path, log, secs = fut.result()
            print(f"build {name}: {path.name} in {secs:.1f} s "
                  f"({build.SOURCES[name][1]}, started with the others)")
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

    # the select kernel at the decoders' pool shapes (U = 8), bitwise
    def select_case(N, kcap, beam, seed):
        """Candidates as the decoders make them: many duplicate destinations
        (dst from N/3 states), exact-score ties (scores on a 1/4 grid) and
        NEG + NEG from padded arc slots."""
        r = np.random.default_rng(seed)
        U = 8
        c = (np.round(r.standard_normal((U, N)) * 40) / 4).astype(np.float32)
        c[r.random((U, N)) < 0.2] = np.float32(NEG) + np.float32(NEG)
        d = r.integers(0, N // 3, (U, N)).astype(np.int32)
        a = r.permutation(U * N).reshape(U, N).astype(np.int32)
        b = np.full(U, beam, np.float32)
        return [torch.as_tensor(v, device=dev) for v in (c, d, a, b)]

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    for N, kcap, label in ((2304, 256, "split monophone (256+896)x2"),
                           (4608, 512, "split triphone (512+640)x4"),
                           (12032, 256, "dense monophone 256x47"),
                           (134656, 512, "dense triphone 512x263, two launches")):
        for beam in (40.0, 1e9):
            args = select_case(N, kcap, beam, N + int(beam))
            out = csel.recombine_topk(*args, kcap)
            ref = csel.recombine_topk_plain(*args, kcap)
            ref_cpu = csel.recombine_topk_plain(*(v.cpu() for v in args), kcap)
            torch.cuda.synchronize()
            same = all(torch.equal(bits(o), bits(r)) for o, r in zip(out, ref))
            same_cpu = all(torch.equal(bits(o).cpu(), bits(r)) for o, r in zip(out, ref_cpu))
            ms = cuda_ms(lambda: csel.recombine_topk(*args, kcap))
            plain_ms = cuda_ms(lambda: csel.recombine_topk_plain(*args, kcap))
            # 12 bytes in per candidate, 12 out per kept token; at least
            # two comparisons per candidate (recombine, select)
            b_ms, b_by = bound(12 * 8 * N + 4 * 8 + 12 * 8 * kcap, 2 * 8 * N)
            err = float((out[0] - ref[0]).abs().max())
            alive = int((out[0] > NEG / 2).sum())
            print(f"select U=8 N={N} kcap={kcap} beam={beam:g} ({label}): bitwise equal to "
                  f"the twin on the card {same}, on the CPU {same_cpu}, {alive} live slots; "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library n/a  bound "
                  f"{b_ms:.5f} ms ({b_by})  [{smi}]")
            check(same and same_cpu, f"select N={N} kcap={kcap} beam={beam}: not bitwise "
                                     "equal to its plain twin")
            if N == 2304 and beam == 40.0:   # the split decoder's pool, bench.py's path
                record["select"] = dict(max_abs_err=err, rel_err=0.0, ms=ms, plain_ms=plain_ms,
                                        bound_ms=b_ms, bound_by=b_by, library_ms=None)

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

    counters = (cfb, csel)
    counts = {name: 0 for mod in counters for name in mod.launches}

    def counted(path, fn, expect):
        """fn() with the launch counters set to 0 just before it and read just
        after; the path must have launched exactly `expect` of each kernel
        (0 of those it does not name)."""
        for mod in counters:
            mod.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {name: n for mod in counters for name, n in mod.launches.items()}
        expect = {**dict.fromkeys(got, 0), **expect}
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

    # ---- 5. the decode ------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="dsr_tpu_torch_graphs_") as cache_dir:
        os.environ["DSR_TPU_TORCH_CACHE"] = cache_dir   # a fresh build, not a cached graph
        try:
            t0 = time.perf_counter()
            task = lvcsr.build_task(lvcsr.LvcsrConfig())
            t_task = time.perf_counter() - t0
            t0 = time.perf_counter()
            sg = sd.build_split_graph(task.graph, a0=2, device=dev)
            t_split = time.perf_counter() - t0
            t0 = time.perf_counter()
            tg = tk.build_token_graph(task.graph, device=dev)
            t_dense = time.perf_counter() - t0
            cfg300 = lvcsr.LvcsrConfig(vocab_size=300, n_tokens=5000, branching=3)
            task300 = lvcsr.build_task(cfg300)
        finally:
            del os.environ["DSR_TPU_TORCH_CACHE"]
    print(f"graph build V=2000 trigram (the port's WFST core): {task.graph.num_states} states, "
          f"{task.graph.num_arcs} arcs, a_max {tg.a_max}, {t_task:.2f} s "
          f"({task.build_stats}); split tables a0=2 ({sg.num_groups} overflow groups) "
          f"{t_split:.2f} s; dense tables {t_dense:.2f} s")

    U, T, kcap, beam, eg = 8, 1000, 256, 40.0, 896    # bench.py's decode shape
    P = task.num_pdfs
    ll_np = np.random.default_rng(0).standard_normal((U, T, P)).astype(np.float32)
    ll = torch.as_tensor(ll_np, device=dev)
    lens = np.full(U, T)
    audio_s = U * T / 125.0
    decoders = {
        "split": lambda: sd.decode_batch_split(sg, ll, lens, kcap=kcap, beam=beam, eg=eg),
        "dense": lambda: tk.decode_batch(tg, ll, lens, kcap=kcap, beam=beam),
    }
    decode_s = {}
    for name, run in decoders.items():
        run()                                          # warm-up
        out = counted(f"decode {name} 8 x 1000 frames", run, {"select": T})
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reps = 2
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        decode_s[name] = start.elapsed_time(end) / reps / 1e3
        check(out[0].shape == (U, T) and bool(torch.isfinite(out[1]).all()),
              f"decode {name} outputs")
        extra = (f", spill frames {int(out[2].sum())}, overflow frames {int(out[3].sum())}"
                 if name == "split" else "")
        print(f"decode {name} U=8 T=1000 kcap=256 beam=40: {decode_s[name]:.3f} s = "
              f"{audio_s / decode_s[name]:.1f} audio-s/s, {decode_s[name] / T * 1e3:.3f} ms "
              f"per frame; words per utterance "
              f"{[int((o != 0).sum()) for o in out[0]]}{extra}  [{smi}]")
    # the device's busy share: kernel time per frame from the profiler (over
    # 100 frames) against the timed decode's time per frame
    for name, g_ in (("split", sg), ("dense", tg)):
        def run100(name=name, g_=g_):
            x = ll[:, :100]
            if name == "split":
                return sd.decode_batch_split(g_, x, np.full(U, 100), kcap=kcap, beam=beam, eg=eg)
            return tk.decode_batch(g_, x, np.full(U, 100), kcap=kcap, beam=beam)
        run100()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run100()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
        busy_us = sum(e.self_device_time_total for e in events) / 100
        if busy_us > 0:
            top = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 100:.1f}"
                            for e in events[:6])
            print(f"decode {name}: device busy {busy_us:.1f} us per frame of "
                  f"{decode_s[name] / T * 1e6:.1f} us (idle share "
                  f"{100 * (1 - busy_us * 1e-6 / (decode_s[name] / T)):.1f} %); kernels "
                  f"(us per frame): {top}  [{smi}]")
        else:
            print(f"decode {name}: device busy share not measured (the profiler recorded no "
                  "device time)")
    # the host's share: the traceback alone, from a finished token pass
    states0, scores0 = tk.start_tokens(sg, U, kcap)
    sf, scf, ts, ta, _, _ = tk.token_pass(
        lambda s_, sc_, l_: sd.candidates(sg, s_, sc_, l_, eg), ll, lens, states0, scores0,
        beam, kcap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src_of_row = sg.src_of_row.cpu().numpy()
    tk.traceback_tables(sg, ts, ta, sf, scf, lens, lambda a: src_of_row[a // sg.a0])
    t_back = time.perf_counter() - t0
    sel_ms = {"split": record["select"]["ms"]}
    args = select_case(12032, 256, 40.0, 12032 + 40)
    sel_ms["dense"] = cuda_ms(lambda: csel.recombine_topk(*args, 256))
    for name in decoders:
        share = sel_ms[name] * T / 1e3 / decode_s[name]
        print(f"decode {name}: select kernel {sel_ms[name]:.4f} ms x {T} frames = "
              f"{sel_ms[name] * T / 1e3:.3f} s ({100 * share:.1f} % of the decode); "
              f"traceback {t_back:.3f} s; the rest is the frame loop's "
              f"gathers, adds and launches  [{smi}]")

    # card against the CPU plain path: utterances 0-1, frames 0-199
    cpu_graphs = {"split": sd.build_split_graph(task.graph, a0=2, device="cpu"),
                  "dense": tk.build_token_graph(task.graph, device="cpu")}
    card_graphs = {"split": sg, "dense": tg}
    expanders = {"split": lambda g: (lambda s_, sc_, l_: sd.candidates(g, s_, sc_, l_, eg)),
                 "dense": lambda g: (lambda s_, sc_, l_: tk.candidates(g, s_, sc_, l_))}
    ll_cpu = torch.as_tensor(ll_np[:2, :200])
    for name in decoders:
        toks = []
        for g, x in ((card_graphs[name], ll), (cpu_graphs[name], ll_cpu)):
            st0, sc0 = tk.start_tokens(g, x.shape[0], kcap)
            toks.append(tk.token_pass(expanders[name](g), x, np.full(x.shape[0], x.shape[1]),
                                      st0, sc0, beam, kcap)[2:5])
        same = all(torch.equal(bits(c[:200, :2].cpu()), bits(h))
                   for c, h in zip(toks[0], toks[1]))
        if name == "split":
            w_card = sd.decode_batch_split(sg, ll[:2, :200], [200, 200], kcap=kcap, beam=beam,
                                           eg=eg)
            w_cpu = sd.decode_batch_split(cpu_graphs[name], ll_cpu, [200, 200], kcap=kcap,
                                          beam=beam, eg=eg)
        else:
            w_card = tk.decode_batch(tg, ll[:2, :200], [200, 200], kcap=kcap, beam=beam)
            w_cpu = tk.decode_batch(cpu_graphs[name], ll_cpu, [200, 200], kcap=kcap, beam=beam)
        same_words = torch.equal(w_card[0], w_cpu[0]) and torch.equal(bits(w_card[1]),
                                                                      bits(w_cpu[1]))
        print(f"decode {name} card vs CPU plain path (utterances 0-1, frames 0-199): token "
              f"states, arcs and scores bitwise equal {same}; words and scores equal "
              f"{same_words}")
        check(same and same_words, f"decode {name}: the card differs from the CPU plain path")

    # in-domain gate (tests/test_lvcsr.py's): V=300 graph, synthetic AM, 0 WER
    rng0 = np.random.default_rng(cfg300.seed)
    lex = lvcsr.make_lexicon(cfg300.vocab_size, rng0)
    text = lvcsr.make_text(sorted(lex), cfg300.n_tokens, cfg300.branching, rng0)
    rng5 = np.random.default_rng(5)
    am = lvcsr.synthetic_am(task300).to(dev)
    tg300 = tk.build_token_graph(task300.graph, device=dev)
    sg300 = sd.build_split_graph(task300.graph, a0=2, device=dev)
    errors = {"dense": 0, "split": 0}
    for sent in [s_[:5] for s_ in text[:4]]:
        feats = lvcsr.synthesize_utterance(task300, sent, rng5)
        ll300 = gmm.loglik(am, torch.as_tensor(feats, device=dev))
        hyp_d = tk.decode(tg300, ll300, kcap=256, beam=60.0)[0]
        hyp_s = sd.decode_split(sg300, ll300, kcap=256, beam=60.0, eg=896)[0]
        for name, hyp in (("dense", hyp_d), ("split", hyp_s)):
            words = [task300.words.name(int(w)) for w in hyp if w]
            errors[name] += int(words != sent)
    print(f"in-domain gate V=300 ({task300.graph.num_states} states), 4 sentences of 5 "
          f"words: sentences with errors {errors}")
    check(errors == {"dense": 0, "split": 0}, "in-domain decode gate")

    # streaming: front end + chunked decode against the offline decode
    pipe_s = DsrPipeline(fb=cfg, geometry=ArrayGeometry.circular(8, 0.10),
                         beamformer=BeamformerConfig(kind="mvdr"))
    rs = np.random.default_rng(6)
    am_s = gmm.GmmParams(rs.standard_normal((task300.num_pdfs, 2, 13)) * 3,
                         (0.5 + rs.random((task300.num_pdfs, 2, 13))) * 5,
                         np.log(np.full((task300.num_pdfs, 2), 0.5))).to(dev)
    x_s = rs.standard_normal((8, int(2 * SR))).astype(np.float32)
    Y_off = pipe_s.beamform_subbands(fb.analysis(torch.as_tensor(x_s, device=dev), cfg),
                                     SOURCE)[0]
    f_off = ft.mfcc_from_subbands(Y_off, cfg.M, SR)
    cep_mean = f_off.mean(dim=0).cpu().numpy()
    ol_off, sc_off = tk.decode(tg300, gmm.loglik(am_s, f_off - torch.as_tensor(cep_mean,
                                                                                device=dev)))
    words_off = [int(w) for w in ol_off if w]
    cuts = [0, 1500, 5000, 5600, 12000, 20000, x_s.shape[-1]]
    chunks = [x_s[:, a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    rec = StreamingRecognizer(pipe_s, lambda f: gmm.loglik(am_s, f), tg300, SOURCE,
                              cep_mean=cep_mean)
    words_s, score_s = counted("streaming", lambda: rec.run(chunks),
                               {"analysis": len(chunks), "select": Y_off.shape[0]})
    print(f"streaming recogniser ({len(chunks)} ragged chunks, {Y_off.shape[0]} frames): "
          f"{len(words_s)} words, equal to the offline decode's {words_s == words_off}; "
          f"score {score_s:.3f} vs offline {float(sc_off):.3f}")
    check(words_s == words_off and abs(score_s - float(sc_off)) < 0.1,
          "streamed words equal the offline decode")
    print(f"main path launches, all paths: {counts}")

    kernels = []
    replaces = {"analysis": "dsr_tpu/ops/pallas/filterbank.py:188",
                "analysis_beamform": "dsr_tpu/ops/pallas/filterbank.py:338",
                "synthesis": "dsr_tpu/ops/pallas/filterbank.py:710",
                "select": "dsr_tpu/ops/pallas/select.py:221"}
    for name in ("analysis", "analysis_beamform", "synthesis", "select"):
        r = record[name]
        source = "select.cu" if name == "select" else "filterbank.cu"
        kernels.append({"name": name, "route": "cuda",
                        "source": f"dsr_tpu_torch/ops/cuda/csrc/{source}",
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
