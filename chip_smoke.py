#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dsr_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:
  1. environment (torch, CUDA, nvcc, card name and power limit), then the
     builds, all started together, of every native source in this checkout
     (the CUDA kernels with nvcc, the WFST core with g++), each timed;
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes and at a D = 256 config, with the time of each;
     the select kernel at the decoders' four pool shapes, bitwise; the GSC
     kernel at 1 and 8 utterances of 8 ch x 1000 frames (error at frames
     40 / 500 / 1000, two chunks threaded through wa0 == one pass) and at
     2, 16, 17 and 64 channels, each time beside its byte bound and its
     chain floor (estimated); the steering kernel at 8 and 16 ch x 1000
     frames, static and per-frame delays; the banded Viterbi kernel at the
     force-align shape and a batch, bitwise (and at S = 1, 31, 33, 1,024
     and 1,025 states and a single frame); the shapes that raised before:
     the select kernel at 269,312 candidates with kcap 1024 (bitwise) and
     the filterbank kernels at four configs above the shared-memory opt-in,
     the analysis also at 8 ch x 1 s of three of them, each against
     torch.stft; the select kernel's edge cases (a beam of 1e31 over NEG +
     NEG, a single dst, all dsts distinct, kcap above N, identical
     candidates) in both modes, bitwise; the analysis and the fused
     kernel (unstaged and staged) at M = 65,536 and a prime M, the fused
     kernel also at 7, 63 and 64 channels (not multiples of its cluster's
     split); and, untimed, each kernel's variants for inputs beyond those
     (delta, W, the select table or the FFT's tables in device memory,
     the synthesis through device memory); the synthesis also on random
     spectra with imaginary DC and Nyquist parts from a later start, at
     M = 256 and the odd M = 127; the GSC kernel also at 17 channels, at U
     = 8 for 2 to 64 channels, and at 1, 2, 5, 10 and 12 frames;
  3. the front end's main path: `DsrPipeline.process` (MVDR) on 4 requests
     of 8 ch x 4 s with GMM scoring, the `entry` forward, and the serving
     beamform (fused analysis+beamform -> synthesis) at 64 ch x 8 s; the
     launch counters are set to 0 just before each path and read just
     after it, and each path must launch exactly its kernels;
  4. the outputs: finite, card == CPU plain path on the same request,
     `entry` == its plain composition on the card, DS reconstruction
     < -50 dB; then the serving beamform's audio-seconds per second;
  5. BASELINE config 3's tracked front end on an 8 s, 8-mic free-field
     recording made here from a seed: GCC-PHAT TDOAs over all 28 pairs ->
     IEKF from a displaced prior (mean steering error < 30 us) -> MVDR-
     quiescent GSC through the GSC kernel and DS along the tracked
     trajectory through the steering kernel -> synthesis -> MFCC + CMN,
     counted, against the CPU plain path fed the same delays; then
     `DsrPipeline(kind="gsc")` with the Zelinski post-filter (`process`,
     `process_streaming`) and with WPE (`process`), card against CPU;
  6. the decode: the bench graph (V = 2000 trigram HCLG) built by the
     port's own WFST core, the degree-split (a0 = 2, eg = 896) and dense
     batched decodes at bench.py's shape (8 x 1000 frames, kcap 256, beam
     40) with exactly 1000 select launches each and their audio-seconds
     per second; the card's tokens and words against the CPU plain path's
     (utterances 0-1, frames 0-199, bitwise); the in-domain 0-WER gate on
     the V = 300 graph for both decoders; the streaming recogniser
     (front end + chunked decode) against the offline decode; and the
     streaming recogniser over a GSC pipeline, its subband frames against
     the CPU plain path's;
  7. BASELINE config 1 on a synthetic corpus made here from a seed: MFCC +
     CMN, ML training of whole-word GMM-HMMs on the card, forced alignment
     of every training utterance through the banded Viterbi kernel (card
     against the CPU's dense alignment, ties counted), the clean word-loop
     decode (WER <= 0.05), the 8-ch delay-and-sum path (analysis -> DS ->
     synthesis -> MFCC -> decode, WER <= 0.15, its utterances aligned
     through the kernel), and the phone task's bigram HCLG decode; trained
     means and decoded words against the CPU plain path;
  8. L, lattices: 4 in-domain sentences of about 500 frames on the V = 2000
     graph, decoded with 4 alternates per token through the select
     kernel's lattice mode; link posteriors sum to 1 per frame, the
     lattice's 1-best equals the decode's words, oracle errors and
     consensus against the reference words with their host seconds, and
     one sentence's token and alt tables against the CPU plain path's;
  9. MM, lattice MMI at config 1's width: `ebw_train` of the phone task's
     GMMs over the 60 training utterances and its bigram HCLG, 4
     iterations, a strictly increasing criterion; 5 utterances x 2
     iterations against the CPU plain path; the lattice denominator with
     exhaustive and pruned settings against the full-graph one;
  10. SB, the staged buffer bank: bench.py's 8 buffers of 64 ch x 8 s
     staged once on the card, every buffer by int and by device index
     against the unstaged fused kernel, bitwise, and a serving loop over
     the bank with no host readback;
  11. FE, the rest of the front end (slice 8): FE1 a barge-in front end
     at config 2's width (64-mic circular 0.20 m, 8 s, M = 256 m = 4 r =
     2) on a recording made here (a talker at SOURCE in two bursts, a
     loudspeaker 0.3 m from the array playing a prompt throughout, 20 dB
     sensor SNR): fused analysis + MVDR -> the prompt's analysis ->
     voice-prompt NLMS and Kalman AEC -> Sohn and energy VADs, segments ->
     spectral subtraction -> synthesis -> 400 / 160 Hamming frames ->
     warped-MVDR cepstra (order 30) -> deltas -> splice, exactly analysis
     / analysis_beamform / synthesis 1 each, card against the CPU plain
     path (1e-4 subbands and waveform, 1e-3 cepstra, equal decisions but
     at the threshold), the SAD gates (hits >= 0.9, false alarms <= 0.2),
     ERLE, SI-SDR / segSNR / fwSegSNR with and without AEC, each stage's
     ms and the frame loops' device-busy share; FE2 the designed
     prototypes of M = 128 and 512 (no shipped file) through the kernels
     against their twins and reconstruction < -50 dB, the fused kernel at
     M = 512 on 64 ch x 8 s; FE3 the cosine-modulated and PR-FFT banks
     and overlap-add / -save (4,096 taps) on FE1's recording, card against
     CPU; FE4 a 32-mic open sphere's modal beamformer (order 3) on four
     5 m sources, card against CPU, the on-look / off-look power ratio;
  12. T, the triphone LVCSR decode: the V = 300 triphone task built by the
     port (its figures against the JAX package's), its analytic tied AM on
     the card, 4 in-domain sentences through the dense decoder (kcap 192)
     and the degree-split one (an `eg` sized from the graph, no overflowed
     frame), exact words, one select launch per frame, and sentence 0's
     token tables against the CPU plain path's, bitwise;
  13. TT, tied triphones trained from audio (tests/test_tritrain_wer.py's
     system): 30 reverberant 8-mic recordings (utils/room.py) -> MVDR
     (analysis -> weights -> synthesis) -> MFCC + CMN -> monophone EM ->
     one banded-kernel alignment per utterance -> tree -> tied EM, the
     tree and tied parameters against the CPU plain path's, then the
     60-distractor triphone and monophone graphs and 6 eval utterances
     through the single mic and MVDR with the JAX test's WER gates;
  14. AD, adaptation on config 1's phone task: MLLR, fMLLR, SAT (host loop
     and batched), MLLR regression classes and VTLN with the JAX tests'
     gates, each against the CPU plain path on the same inputs;
  P (run after phase 6, whose graph and logliks it reuses), BASELINE config
     4 on a one-rank NCCL group: P1 the graph-sharded decode
     (`make_sharded_decode` on a (1, 1, 1) mesh) of phase 6's 8 x 1000
     frames, bitwise against the dense decode, exactly 2 select launches a
     frame (local recombine and merge), its audio-seconds per second beside
     the dense decode's in turns and its device-busy share; P2 the n = 2
     and 4 shard exchange simulated on the card (utterance 0) against the
     dense decode; P3 the V = 20k trigram graph (config 4's premise) built
     by the port, the largest shard's tables built on the host at n = 1, 2
     and 4, and its sharded decode (8 x 100 frames) bitwise against
     `decode_batch` with the peak device memory of each; P4 ring, Ulysses,
     halo and pipeline collectives at one rank against the CPU plain path.
Phase 2 also holds the select kernel's lattice mode to its twin bitwise
(U = 8 at the four pool shapes, nlat 1 / 3 / 4 / 8, and kcap 155 with nlat
512) and the synthesis at M = 4096, m = 8, r = 4096 (m r = 32,768, through
device memory) to its twin.
The last two lines are the kernels' JSON record and the verdict
`{"ok": true, "device": {...}}`.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

import concurrent.futures
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

SR = 16000.0
SOURCE = np.array([0.0, 2.0, 0.0])
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, FP32 outside the tensor cores
TOL = 1e-5                     # max |kernel - plain| / max |plain|, as tests/test_pallas.py
# The GSC and steering kernels' gate: tests/test_pallas.py holds their Pallas
# versions to 1e-5 (GSC) and 1e-4 (steering); the GSC kernel's sums run in
# another order than the twin's over 1000 dependent frames, so both get 1e-4.
TOL_ADAPTIVE = 1e-4
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


def exact_tie(params, task, feats, words, segs_a, segs_b) -> bool:
    """True when two segmentations of one utterance's alignment chain score
    exactly the same on `params`' log-likelihoods, summed as the banded
    kernel sums them (float32, frame by frame: delta + weight, then + ll)."""
    from dsr_tpu_torch.asr.am import gmm

    ids, A, _, _ = task.align_graph(words)
    ll = gmm.loglik(params, torch.as_tensor(feats, device=params.means.device))[:, ids]
    ll = ll.cpu().numpy()
    A = np.asarray(A, np.float32)

    def score32(segs):
        pos = np.repeat(np.arange(len(segs)), [e - b for _, b, e in segs])
        s = ll[0, pos[0]]
        for t in range(1, len(pos)):
            s = (s + A[pos[t - 1], pos[t]]) + ll[t, pos[t]]
        return s

    return score32(segs_a) == score32(segs_b)


def max_rel(p, q) -> float:
    """max |a - b| / (|b| + 1) over the GMM parameters of p (any device)
    against q (on the CPU)."""
    def err(a, b):
        return float(((a.cpu() - b).abs() / (b.abs() + 1)).max())

    return max(err(getattr(p, n), getattr(q, n)) for n in ("means", "variances", "logweights"))


# The JAX package's build_task_tri at V = 300 (its own native core on the
# CPU): the port's graph must have exactly these figures.
TRI_V300 = {"num_states": 213145, "num_arcs": 841161, "max_outdeg": 263,
            "seen_triphones": 21871, "tied_pdfs": 1080}


def phase_tri_decode(ctx, cfg_t=None, expect=TRI_V300, n_sents=4):
    """T: the triphone LVCSR task built by the port (V = 300 trigram, C,
    likelihood-gain tree, H_tri), its analytic tied AM on the card, and
    tests/test_lvcsr.py's in-domain gate through the dense and the
    degree-split decoders; words exact, one select launch per frame, no
    overflowed frame, sentence 0's token tables card == CPU bitwise."""
    from dsr_tpu_torch.asr import lvcsr
    from dsr_tpu_torch.asr.am import gmm
    from dsr_tpu_torch.asr.decoder import split_decoder as sd
    from dsr_tpu_torch.asr.decoder import topk_decoder as tk

    dev, smi = ctx.dev, ctx.smi
    cfg_t = cfg_t or lvcsr.LvcsrConfig(vocab_size=300, n_tokens=5000, branching=3)
    t0 = time.perf_counter()
    task = lvcsr.build_task_tri(cfg_t)
    t_build = time.perf_counter() - t0
    got = {k: task.build_stats[k] for k in expect}
    print(f"T: triphone graph V={cfg_t.vocab_size} built by the port's WFST core and tree: "
          f"{got} in {t_build:.2f} s on the host (G and CLG {task.build_stats['build_fsts_s']} s, "
          f"tree, H_tri and HCLG {task.build_stats['build_tri_s']} s)")
    check(got == expect, f"T: the triphone graph {got} differs from the JAX package's {expect}")

    am = lvcsr.synthetic_am_tri(task, device=dev)
    tg = tk.build_token_graph(task.graph, device=dev)
    sg = sd.build_split_graph(task.graph, a0=2, device=dev)
    kcap, beam = 192, 60.0
    eg = sd.overflow_budget(sg, kcap)    # the most groups kcap tokens can ask for
    rng0 = np.random.default_rng(cfg_t.seed)
    lex = lvcsr.make_lexicon(cfg_t.vocab_size, rng0)
    text = lvcsr.make_text(sorted(lex), cfg_t.n_tokens, cfg_t.branching, rng0)
    rs = np.random.default_rng(7)
    sents = [s[:3] for s in text[:n_sents]]
    lls = [gmm.loglik(am, torch.as_tensor(lvcsr.synthesize_utterance_tri(task, s, rs), device=dev))
           for s in sents]
    frames = [int(x.shape[0]) for x in lls]
    audio = sum(frames) / 125.0          # the front end's frame rate at M = 256, r = 2
    decoders = {"dense": lambda x: tk.decode(tg, x, kcap=kcap, beam=beam),
                "split": lambda x: sd.decode_split(sg, x, kcap=kcap, beam=beam, eg=eg)}
    pools = {"dense": f"{kcap} x {tg.a_max} = {kcap * tg.a_max}",
             "split": f"({kcap} + {eg}) x {sg.a0} = {(kcap + eg) * sg.a0}"}
    for name, run in decoders.items():
        run(lls[0][:20])                 # warm-up
        outs, secs = ctx.timed(lambda: ctx.counted(
            f"T: {name} decode ({len(sents)} sentences)", lambda: [run(x) for x in lls],
            {"select": sum(frames)}))
        hyps = [[task.words.name(int(w)) for w in o[0] if w] for o in outs]
        overflow = sum(int(o[3]) for o in outs) if name == "split" else 0
        print(f"T: {name} decode of {len(sents)} sentences ({frames} frames), kcap {kcap}, beam "
              f"{beam}, select pool {pools[name]} candidates: {secs:.3f} s = "
              f"{audio / secs:.1f} audio-s/s on the host clock; sentences with errors "
              f"{sum(h != s for h, s in zip(hyps, sents))}"
              + (f", overflow frames {overflow} (eg {eg})" if name == "split" else "")
              + f"  [{smi}]")
        check(hyps == sents, f"T: {name} decode words {hyps} differ from {sents}")
        check(overflow == 0, f"T: the split decode overflowed on {overflow} frames")

    # sentence 0's token tables, card against the CPU plain path
    cpu = {"dense": tk.build_token_graph(task.graph, device="cpu"),
           "split": sd.build_split_graph(task.graph, a0=2, device="cpu")}
    expand = {"dense": lambda g: (lambda s_, sc_, l_: tk.candidates(g, s_, sc_, l_)),
              "split": lambda g: (lambda s_, sc_, l_: sd.candidates(g, s_, sc_, l_, eg))}
    for name, g in (("dense", tg), ("split", sg)):
        toks = []
        for g_, x in ((g, lls[0][None]), (cpu[name], lls[0][None].cpu())):
            st0, sc0 = tk.start_tokens(g_, 1, kcap)
            toks.append(tk.token_pass(expand[name](g_), x, np.array([x.shape[1]]), st0, sc0,
                                      beam, kcap)[2:5])
        same = all(torch.equal(ctx.bits(c.cpu()), ctx.bits(h)) for c, h in zip(*toks))
        print(f"T: {name} sentence 0 token states, arcs and scores card vs CPU plain path "
              f"bitwise equal {same}")
        check(same, f"T: the {name} decode's token tables differ from the CPU plain path's")


def profile_frames(fn, frames: int) -> tuple[float, str]:
    """Device microseconds a frame of fn() (the profiler's kernel time over
    `frames` frames; 0.0 when the profiler recorded no device time), and the
    host operations with the most self CPU time, in microseconds a frame."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / frames
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    top = ", ".join(f"{e.key[:40]} {e.self_cpu_time_total / frames:.1f} ({e.count // frames})"
                    for e in host[:8])
    return busy, top


def phase_parallel(ctx, task, tg, ll, kcap=256, beam=40.0):
    """P, BASELINE config 4 on one card: a one-rank NCCL group (FileStore
    rendezvous in a temporary directory) and a (1, 1, 1) mesh.  P1 the
    graph-sharded decode of phase 6's V = 2000 graph and logliks (U x T),
    bitwise against the dense decode, two select launches a frame; P2 the
    n = 2 and 4 shard exchange simulated on the card against the dense
    decode's utterance 0; P3 the V = 20k trigram graph of config 4's
    premise, built by the port, each shard's tables built on the host at n
    = 1, 2 and 4, and its sharded decode against the dense one; P4 ring,
    Ulysses, halo and pipeline collectives against the CPU plain path."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from dsr_tpu_torch.asr import lvcsr
    from dsr_tpu_torch.asr.decoder import topk_decoder as tk
    from dsr_tpu_torch.config import MeshConfig
    from dsr_tpu_torch.parallel import longctx, make_mesh
    from dsr_tpu_torch.parallel.decoder import (make_sharded_decode, shard_token_graph,
                                                simulate_sharded_kernel_decode)
    from dsr_tpu_torch.parallel.mesh import initialize_distributed
    from dsr_tpu_torch.parallel.pipeline_parallel import pipeline_apply

    dev, smi, bits = ctx.dev, ctx.smi, ctx.bits
    U, T = ll.shape[:2]
    lens = np.full(U, T)
    audio_s = U * T / 125.0

    def dense_tokens(g, x, n_lens, k):
        st0, sc0 = tk.start_tokens(g, x.shape[0], k)
        out = tk.token_pass(lambda s_, c_, l_: tk.candidates(g, s_, c_, l_), x, n_lens, st0,
                            sc0, beam, k)
        return [t.transpose(0, 1) for t in out[2:5]]

    def same_bits(a, b):
        return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))

    def secs(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="dsr_tpu_torch_store_") as store:
        initialize_distributed(f"file://{store}/rendezvous", 1, 0, heartbeat_timeout_s=600,
                               device="cuda", always=True)
        try:
            print(f"P: process group {dist.get_backend()} of {dist.get_world_size()} rank")
            mesh = make_mesh(MeshConfig())

            # ---- P1: the sharded decode at the decode cell's width
            t_build = time.perf_counter()
            run = make_sharded_decode(mesh, task.graph, kcap=kcap, beam=beam, return_tokens=True)
            t_build = time.perf_counter() - t_build
            run(ll[:, :20], np.full(U, 20))                            # warm-up
            out = ctx.counted(f"P1: sharded decode (model 1) {U} x {T} frames",
                              lambda: run(ll, lens), {"select": 2 * T})
            ol_d, sc_d = tk.decode_batch(tg, ll, lens, kcap=kcap, beam=beam)
            same_tok = same_bits(out[3:], dense_tokens(tg, ll, lens, kcap))
            same_words = torch.equal(out[0], ol_d)
            same_scores = torch.equal(bits(out[1]), bits(sc_d))
            spill = int(out[2].sum())
            print(f"P1: shard tables (1 of 1) placed in {t_build:.2f} s; sharded vs dense decode "
                  f"(U={U}, T={T}, kcap {kcap}, beam {beam}): token states, arcs and scores "
                  f"bitwise equal {same_tok}, words equal {same_words}, scores bitwise equal "
                  f"{same_scores}, spill frames {spill}")
            check(same_tok and same_words and same_scores and spill == 0,
                  "P1: the sharded decode differs from the dense decode")
            plain = make_sharded_decode(mesh, task.graph, kcap=kcap, beam=beam)
            timing = {"dense": [], "sharded": []}
            for name in ("dense", "sharded", "sharded", "dense"):
                fn = (plain if name == "sharded" else
                      lambda x, n_: tk.decode_batch(tg, x, n_, kcap=kcap, beam=beam))
                timing[name].append(secs(lambda: fn(ll, lens))[1])
            t_sh, t_de = (sum(timing[k]) / 2 for k in ("sharded", "dense"))
            busy, host_ops = profile_frames(lambda: plain(ll[:, :100], np.full(U, 100)), 100)
            busy_txt = (f"device busy {busy:.1f} us per frame of {t_sh / T * 1e6:.1f} us (idle "
                        f"share {100 * (1 - busy * 1e-6 / (t_sh / T)):.1f} %)" if busy > 0 else
                        "device busy share not measured (the profiler recorded no device time)")
            print(f"P1: sharded decode U={U} T={T} kcap={kcap} beam={beam:g}: {t_sh:.3f} s = "
                  f"{audio_s / t_sh:.1f} audio-s/s, {t_sh / T * 1e3:.3f} ms per frame; dense "
                  f"in turns (D S S D) {t_de:.3f} s = {audio_s / t_de:.1f} audio-s/s; sharded / "
                  f"dense throughput {t_de / t_sh:.3f} (runs {timing}); {busy_txt}  [{smi}]")
            busy_d, host_d = profile_frames(
                lambda: tk.decode_batch(tg, ll[:, :100], np.full(U, 100), kcap=kcap, beam=beam), 100)
            print(f"P1: host operations by self CPU us a frame (calls a frame), sharded: "
                  f"{host_ops}; dense (device busy {busy_d:.1f} us a frame): {host_d}")
            del run, plain

            # ---- P2: n >= 2 shards on one card
            for n in (2, 4):
                sim, t_sim = secs(lambda: ctx.counted(
                    f"P2: {n} shards simulated, utterance 0",
                    lambda: simulate_sharded_kernel_decode(tg, ll[0], n, kcap=kcap, beam=beam),
                    {"select": 2 * T}))
                ok = (torch.equal(sim[0], ol_d[0]) and np.float32(sim[1]).view(np.int32)
                      == sc_d[0].numpy().view(np.int32))
                print(f"P2: {n} shards on one card, utterance 0 ({T} frames, kcap {kcap}, beam "
                      f"{beam:g}): {t_sim:.3f} s on the host clock; olabels and score equal to "
                      f"the dense decode's {ok} (score {sim[1]:.4f})  [{smi}]")
                check(ok and sim[2] == 0, f"P2: {n} simulated shards differ from the dense decode")

            # ---- P3: config 4's premise graph, V = 20k trigram
            cfg20 = lvcsr.LvcsrConfig(vocab_size=20_000, n_tokens=300_000, branching=5)
            with tempfile.TemporaryDirectory(prefix="dsr_tpu_torch_graphs_") as cache_dir:
                os.environ["DSR_TPU_TORCH_CACHE"] = cache_dir
                try:
                    task20, t20 = secs(lambda: lvcsr.build_task(cfg20))
                finally:
                    del os.environ["DSR_TPU_TORCH_CACHE"]
            g20 = task20.graph
            a_max = int(np.bincount(g20.src, minlength=g20.num_states).max())
            dense_b = g20.num_states * (16 * a_max + 4)
            print(f"P3: graph build V=20k trigram (the port's WFST core): {g20.num_states} "
                  f"states, {g20.num_arcs} arcs, a_max {a_max}, {t20:.2f} s "
                  f"({task20.build_stats}); dense token tables {dense_b} bytes")
            shard_b = {}
            for n in (1, 2, 4):
                sizes, t0 = [], time.perf_counter()
                for r in range(n):
                    sh = shard_token_graph(g20, r, n, "cpu")
                    sizes.append(sum(t.nbytes for t in sh[:5]))
                    del sh
                shard_b[n] = max(sizes)
                print(f"P3: n = {n}: the largest shard's tables {shard_b[n]} bytes "
                      f"({shard_b[n] / dense_b:.4f} of dense), each built on the host "
                      f"({time.perf_counter() - t0:.1f} s for all {n})")
            check(shard_b[1] == dense_b and shard_b[2] < dense_b and shard_b[4] < shard_b[2],
                  "P3: shard sizes")
            U20, T20, k20 = 8, 100, 128
            ll20 = torch.as_tensor(np.random.default_rng(20).standard_normal(
                (U20, T20, task20.num_pdfs)).astype(np.float32), device=dev)
            lens20 = np.full(U20, T20)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run20, t_place = secs(lambda: make_sharded_decode(mesh, g20, kcap=k20, beam=beam,
                                                              return_tokens=True))
            out20, t_dec = secs(lambda: ctx.counted("P3: sharded decode V=20k",
                                                    lambda: run20(ll20, lens20),
                                                    {"select": 2 * T20}))
            peak_sh = torch.cuda.max_memory_allocated()
            del run20
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tg20, t_dense = secs(lambda: tk.build_token_graph(g20, device=dev))
            ol20, sc20 = tk.decode_batch(tg20, ll20, lens20, kcap=k20, beam=beam)
            same20 = (same_bits(out20[3:], dense_tokens(tg20, ll20, lens20, k20))
                      and torch.equal(out20[0], ol20) and torch.equal(bits(out20[1]), bits(sc20)))
            peak_de = torch.cuda.max_memory_allocated()
            del tg20
            torch.cuda.empty_cache()
            print(f"P3: sharded decode (model 1) U={U20} T={T20} kcap {k20} beam {beam:g}: "
                  f"tables placed in {t_place:.2f} s, decode {t_dec:.3f} s; dense tables "
                  f"{t_dense:.2f} s; tokens, words and scores bitwise equal to decode_batch "
                  f"{same20}; spill frames {int(out20[2].sum())}; max_memory_allocated "
                  f"{peak_sh} bytes sharded, {peak_de} dense (the phase's other tensors "
                  f"{base} bytes)  [{smi}]")
            check(same20 and int(out20[2].sum()) == 0, "P3: the V=20k sharded decode differs")

            # ---- P4: the collectives at one rank
            B, Ta, H, dh, maxd = 2, 1024, 4, 64, 128
            rng = np.random.default_rng(4)
            q, k, v = (rng.standard_normal((B, Ta, H, dh)).astype(np.float32) for _ in range(3))
            bias = (0.1 * rng.standard_normal((2 * maxd + 1, H))).astype(np.float32)
            mask = np.arange(Ta)[None, :] < np.array([Ta, Ta - 300])[:, None]
            hx = rng.standard_normal((B, Ta, 16)).astype(np.float32)
            pw = {"W": (rng.standard_normal((1, 32, 32)) * 0.3).astype(np.float32),
                  "b": (rng.standard_normal((1, 32)) * 0.1).astype(np.float32)}
            xs = rng.standard_normal((4, 2, 5, 32)).astype(np.float32)
            cpu = lambda a: torch.as_tensor(a)                       # noqa: E731
            gpu = lambda a: torch.as_tensor(a, device=dev)           # noqa: E731
            pos = torch.arange(Ta)
            logits = (torch.einsum("bthd,bshd->bhts", cpu(q), cpu(k)) / math.sqrt(dh)
                      + longctx.relpos_bias_block(cpu(bias), pos, pos, maxd))
            attn = torch.softmax(torch.where(cpu(mask)[:, None, None, :], logits, -1e30), -1)
            ref_attn = torch.einsum("bhts,bshd->bthd", attn, cpu(v))

            def layer(p, x):
                return x + torch.tanh(x @ p["W"] + p["b"])
            group = mesh.get_group("subband")
            stages = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("stage",))
            cases = {
                "ring": (lambda: longctx.ring_attention(gpu(q), gpu(k), gpu(v), group, gpu(bias),
                                                        maxd, kv_mask=gpu(mask)), ref_attn),
                "ulysses": (lambda: longctx.ulysses_attention(gpu(q), gpu(k), gpu(v), group,
                                                              gpu(bias), maxd,
                                                              kv_mask=gpu(mask)), ref_attn),
                "halo": (lambda: longctx.exchange_halo(gpu(hx), group, 3),
                         torch.nn.functional.pad(cpu(hx), (0, 0, 3, 3))),
                "pipeline": (lambda: pipeline_apply(stages, "stage", layer,
                                                    {n_: gpu(a) for n_, a in pw.items()},
                                                    gpu(xs)),
                             layer({n_: cpu(a)[0] for n_, a in pw.items()}, cpu(xs))),
            }
            for name, (fn, ref) in cases.items():
                got, t_fn = secs(fn)
                err = rel_err(got.cpu(), ref)
                print(f"P4: {name} at one rank (B={B}, T={Ta}, H={H}, dh={dh} for attention): "
                      f"card vs CPU plain path rel err {err:.2e} (bound 1e-4), {t_fn * 1e3:.2f} "
                      f"ms on the host clock  [{smi}]")
                check(got.shape == ref.shape and err <= 1e-4, f"P4: {name} differs")
        finally:
            dist.destroy_process_group()


def phase_tri_train(ctx, n_train=30, n_eval=6, ndist=60):
    """TT: tests/test_tritrain_wer.py's system on the card: reverberant 8-mic
    recordings (utils/room.py) -> MVDR (analysis -> weights -> synthesis) ->
    MFCC + CMN -> monophone EM -> tied-triphone training -> the distractor
    lexicon's triphone and monophone graphs -> eval through the single mic
    and through MVDR, with the JAX test's gates."""
    from dsr_tpu_torch.asr import path as apath
    from dsr_tpu_torch.asr import phone_task, triphone, tritrain
    from dsr_tpu_torch.asr.am import gmm
    from dsr_tpu_torch.asr.decoder import topk_decoder as tk
    from dsr_tpu_torch.asr.fsm import hclg, lm
    from dsr_tpu_torch.asr.fsm.hclg import SymbolTable
    from dsr_tpu_torch.asr.fsm.packed import pack
    from dsr_tpu_torch.asr.train import trainer
    from dsr_tpu_torch.config import ArrayGeometry
    from dsr_tpu_torch.ops import beamforming as bf
    from dsr_tpu_torch.ops import features as ft
    from dsr_tpu_torch.ops import filterbank as fb
    from dsr_tpu_torch.utils import corpus, room

    dev, cfg, smi = ctx.dev, ctx.cfg, ctx.smi
    SRC = np.array([0.6, 1.5, 0.3])                   # tests/test_tritrain_wer.py's scene
    ROOM, CENTER = np.array([5.0, 4.0, 3.0]), np.array([2.0, 1.0, 1.2])
    POS = np.asarray(ArrayGeometry.circular(8, 0.10).positions)
    taus = (room.steering_delays(POS, SRC, 343.0, SR) / SR).astype(np.float32)
    w_mvdr = bf.mvdr_weights(bf.steering_vectors(torch.as_tensor(taus, device=dev), cfg.M, SR),
                             bf.diffuse_coherence(POS, cfg.M, SR, 343.0, device=dev), 1e-2)

    def simulate(x, rng):
        return room.simulate(x, POS, SRC, SR, snr_db=30.0, diffuse_snr_db=2.0, rng=rng,
                             room_dim=ROOM, array_center=CENTER, reflect=0.75,
                             max_order=2).astype(np.float32)

    def mvdr_of(xm):
        xt = torch.as_tensor(xm, device=dev)
        return fb.synthesis(bf.apply_weights(fb.analysis(xt, cfg), w_mvdr), cfg, xt.shape[-1])

    def feats_of(y):
        return ft.cmn(ft.mfcc(torch.as_tensor(y, device=dev), SR)).cpu().numpy()

    task = phone_task.PhoneTask(corpus.VOCAB, states_per_phone=2)
    train_corpus = corpus.make_corpus(n_train, seed=0)
    tsim = np.random.default_rng(23)
    t0 = time.perf_counter()
    sims = [simulate(x, tsim) for _, x in train_corpus]
    t_sim = time.perf_counter() - t0
    feats, t_front = ctx.timed(lambda: ctx.counted(
        f"TT: training front end ({n_train} utterances, MVDR)",
        lambda: [feats_of(mvdr_of(xm)) for xm in sims],
        {"analysis": n_train, "synthesis": n_train}))
    trans = [ws for ws, _ in train_corpus]
    mono, t_mono = ctx.timed(lambda: ctx.counted(
        "TT: monophone EM (4 iterations)",
        lambda: trainer.train(task, feats, trans, num_comp=2, iters=4, device=dev), {}))
    tri, t_tri = ctx.timed(lambda: ctx.counted(
        f"TT: tied triphones (monophone alignments, tree, 3 tied iterations)",
        lambda: tritrain.train_tied_triphone(task, mono, feats, trans, iters=3, device=dev),
        {"viterbi": n_train}))
    check(tri.stats_contexts > tri.tree.num_leaves > 5,
          f"TT: tying {tri.stats_contexts} contexts -> {tri.tree.num_leaves} leaves")
    check(bool(torch.isfinite(tri.params.means).all()), "TT: finite tied means")

    # card against the CPU plain path on the same features and monophones
    mono_cpu = ctx.host_copy(mono)
    tri_cpu = tritrain.train_tied_triphone(task, mono_cpu, feats, trans, iters=3, device="cpu")
    ties = 0
    for f, ws in zip(feats, trans):
        a, b = apath.force_align(task, mono, f, ws), apath.force_align(task, mono_cpu, f, ws)
        if a.segments != b.segments:
            check(exact_tie(mono, task, f, ws, a.segments, b.segments),
                  "TT: a monophone alignment differs from the CPU's off an exact tie")
            ties += 1
    tree_eq = tri.tree == tri_cpu.tree      # dataclass equality: node for node
    check(tree_eq or ties > 0, "TT: the card's tree differs from the CPU's on equal alignments")
    e_tri = max_rel(tri.params, tri_cpu.params) if tree_eq else float("nan")
    print(f"TT: {n_train} reverberant recordings simulated in {t_sim:.2f} s on the host; MVDR "
          f"front end {t_front:.3f} s, monophone EM {t_mono:.3f} s, tied triphones {t_tri:.3f} s "
          f"on the host clock [{smi}]; tree {tri.stats_contexts} contexts -> "
          f"{tri.tree.num_leaves} leaves; card vs CPU plain path: alignments equal in "
          f"{n_train - ties} of {n_train} ({ties} at an exact-score tie), tree equal {tree_eq}, "
          f"tied parameters max |a - b| / (|b| + 1) {e_tri:.2e} (bound 5e-4)")
    check(not tree_eq or e_tri <= 5e-4, "TT: tied training, card vs CPU")

    # the distractor lexicon's bigram graphs: triphone (the trained tree) and monophone
    rng = np.random.default_rng(0)
    plist = sorted(corpus.PHONES)
    lexicon = {w: tuple(corpus.WORDS[w]) for w in corpus.VOCAB}
    for i in range(ndist):
        n = int(rng.integers(2, 6))
        lexicon[f"w{i:04d}"] = tuple(plist[j] for j in rng.integers(0, len(plist), n))
    vocab_all = sorted(lexicon)
    words = SymbolTable(vocab_all)
    texts = [[vocab_all[j] for j in rng.integers(0, len(vocab_all), rng.integers(2, 6))]
             for _ in range(1500)]
    G = lm.arpa_to_fst(lm.train_arpa_bigram(texts, vocab_all), words)
    t0 = time.perf_counter()
    nCLG, tbl, seen = triphone.build_clg_native(lexicon, task.phones, words, G)
    tri_graph, gstats = triphone.finish_tri_hclg_native(nCLG, tbl, tri.tree, task.phones, task.spp,
                                                        seen_tris=seen)
    t_graph = time.perf_counter() - t0
    L, ndis = hclg.build_lexicon_fst(lexicon, task.phones, words, sil_phone="sil")
    P = len(task.phones) - 1
    mono_graph = pack(hclg.compose_hclg(hclg.build_hmm_fst(P, ndis, states_per_phone=task.spp),
                                        L, G, P, ndis))
    tg_t = tk.build_token_graph(tri_graph, device=dev)
    tg_m = tk.build_token_graph(mono_graph, device=dev)

    simrng = np.random.default_rng(11)
    evalc = corpus.make_corpus(n_eval, seed=300)
    xms = [simulate(x, simrng) for _, x in evalc]
    nfr = [1 + (xm.shape[-1] - 400) // 160 for xm in xms]

    def run_eval():
        hyps = {(s, f): [] for s in ("mono", "tri") for f in ("single", "mvdr")}
        for xm in xms:
            for fname, sig in (("single", xm[0]), ("mvdr", mvdr_of(xm))):
                f_ = torch.as_tensor(feats_of(sig), device=dev)
                o_t, _ = tk.decode(tg_t, gmm.loglik(tri.params, f_), kcap=512, beam=80.0)
                o_m, _ = tk.decode(tg_m, gmm.loglik(mono, f_), kcap=256, beam=60.0)
                hyps[("tri", fname)].append([words.name(int(w)) for w in o_t if w])
                hyps[("mono", fname)].append([words.name(int(w)) for w in o_m if w])
        return hyps

    hyps, t_dec = ctx.timed(lambda: ctx.counted(
        f"TT: eval ({n_eval} utterances, single mic and MVDR, triphone and monophone decodes)",
        run_eval, {"analysis": n_eval, "synthesis": n_eval, "select": 4 * sum(nfr)}))
    refs = [list(ws) for ws, _ in evalc]
    wer = {k: ctx.wer_of(refs, h).wer for k, h in hyps.items()}
    print(f"TT: triphone graph ({len(lexicon)} words) {gstats} in {t_graph:.2f} s, monophone graph "
          f"{mono_graph.num_states} states; eval {n_eval} utterances ({sum(nfr)} frames, 4 decodes "
          f"each) {t_dec:.3f} s on the host clock [{smi}]; WER "
          + ", ".join(f"{s}-{f} {w:.3f}" for (s, f), w in wer.items())
          + " (gates: tri-mvdr < tri-single, tri-mvdr <= mono-mvdr)")
    check(wer[("tri", "mvdr")] < wer[("tri", "single")], "TT: MVDR beats the single mic")
    check(wer[("tri", "mvdr")] <= wer[("mono", "mvdr")] + 1e-9,
          "TT: the tied triphones match or beat the monophones through MVDR")


def phase_adapt(ctx):
    """AD: adaptation on config 1's phone task, the recipes of
    tests/test_adapt_mmi_lattice.py (MLLR, fMLLR, SAT in both forms),
    tests/test_mllr_regclass.py and tests/test_vtln.py, on the card; each
    result against the CPU plain path on the same inputs."""
    from dsr_tpu_torch.asr import path as apath
    from dsr_tpu_torch.asr import phone_task
    from dsr_tpu_torch.asr.adapt import fmllr, mllr, sat, vtln
    from dsr_tpu_torch.asr.am import gmm
    from dsr_tpu_torch.asr.train import ml, trainer
    from dsr_tpu_torch.utils import corpus

    dev, smi = ctx.dev, ctx.smi
    task = phone_task.PhoneTask(corpus.VOCAB[:6], states_per_phone=2)
    utts = [(ws, x) for ws, x in corpus.make_corpus(40, seed=0)
            if all(w in task.vocab for w in ws)][:25]
    feats = [ctx.c1_feats(x) for _, x in utts]
    trans = [ws for ws, _ in utts]
    params = trainer.train(task, feats, trans, num_comp=2, iters=3, device=dev)
    host = ctx.host_copy(params)
    S = task.num_states

    def gamma(f, ws):
        al = apath.force_align(task, params, f, ws)
        return np.eye(S, dtype=np.float32)[al.states]

    def fit(p, f):
        return float(gmm.loglik(p, torch.as_tensor(f, device=p.means.device)).max(-1).values.sum())

    def on(p, a):
        return torch.as_tensor(a, device=p.means.device)

    # MLLR and fMLLR of a shifted speaker (occupancies from the card's alignment)
    shift_m = np.zeros(13, np.float32)
    shift_m[:4] = [2.0, -1.0, 0.8, 0.5]
    shift_f = np.zeros(13, np.float32)
    shift_f[:3] = [1.5, -0.7, 0.6]
    f_m, f_f = feats[0] + shift_m, feats[1] + shift_f
    g_m, g_f = ctx.counted("AD: occupancies for MLLR and fMLLR",
                           lambda: (gamma(f_m, trans[0]), gamma(f_f, trans[1])), {"viterbi": 2})

    def mllr_fmllr(p):
        acc = ml.accumulate(p, on(p, f_m), on(p, g_m), ml.zero_accum(S, 2, 13, p.means.device))
        W = mllr.estimate_mllr(p, acc)
        Wf = fmllr.estimate_fmllr(fmllr.accumulate_fmllr(p, on(p, f_f), on(p, g_f)), iters=5)
        f2 = fmllr.apply_fmllr(on(p, f_f), Wf).cpu().numpy()
        return W, fit(mllr.apply_mllr(p, W), f_m) - fit(p, f_m), Wf, fit(p, f2) - fit(p, f_f)

    (W, gain_m, Wf, gain_f), t_mf = ctx.timed(lambda: mllr_fmllr(params))
    W_c, _, Wf_c, _ = mllr_fmllr(host)
    corr = float(np.corrcoef(Wf[:, 13].cpu().numpy()[:3], -shift_f[:3])[0, 1])
    e_m, e_f = rel_err(W.cpu(), W_c), rel_err(Wf.cpu(), Wf_c)
    # tolerances of tests/test_torch_adapt.py: float32 normal equations (MLLR)
    # and row updates (fMLLR) in another summation order
    print(f"AD: MLLR gain {gain_m:.1f} nats (gate > 1), fMLLR gain {gain_f:.1f} nats (gate > 1), "
          f"bias vs shift correlation {corr:.3f} (gate > 0.5); {t_mf:.3f} s for both on the host "
          f"clock [{smi}]; card vs CPU plain path W rel err {e_m:.2e} (bound 2e-3), Wf {e_f:.2e} "
          f"(bound 5e-4)")
    check(gain_m > 1.0 and gain_f > 1.0 and corr > 0.5, "AD: MLLR / fMLLR gains")
    check(e_m <= 2e-3 and e_f <= 5e-4, "AD: MLLR / fMLLR, card vs CPU")

    # SAT: the host loop with re-alignment (every speaker's fit improves),
    # then the batched form against the host loop on fixed occupancies
    shifts = {"spkA": np.r_[np.float32([1.2, -0.6, 0.4]), np.zeros(10, np.float32)],
              "spkB": np.r_[np.float32([-0.9, 0.8, -0.3]), np.zeros(10, np.float32)]}
    speakers = {"spkA": [feats[0] + shifts["spkA"], feats[2] + shifts["spkA"]],
                "spkB": [feats[1] + shifts["spkB"], feats[3] + shifts["spkB"]]}
    spk_words = {"spkA": [trans[0], trans[2]], "spkB": [trans[1], trans[3]]}
    (sat_p, sat_W), t_sat = ctx.timed(lambda: ctx.counted(
        "AD: SAT iteration (2 speakers x 2 utterances, aligned and re-aligned)",
        lambda: sat.sat_iteration(params, speakers, lambda p, f, spk, i: gamma(
            f, spk_words[spk][0 if i is None else i]), num_comp=2), {"viterbi": 8}))
    fits = {spk: (fit(params, u[0]), fit(params, fmllr.apply_fmllr(on(params, u[0]),
                                                                  sat_W[spk]).cpu().numpy()))
            for spk, u in speakers.items()}
    T = min(f.shape[0] for f in feats[:4])
    u4 = [np.asarray(f[:T], np.float32) for f in feats[:4]]
    g4 = [gamma(u, trans[i]) for i, u in enumerate(u4)]
    gmap = {("a", 0): g4[0], ("a", 1): g4[1], ("b", 0): g4[2], ("b", 1): g4[3]}
    fb4 = np.stack([np.stack(u4[:2]), np.stack(u4[2:])])
    gb4 = np.stack([np.stack(g4[:2]), np.stack(g4[2:])])
    gb4_0 = np.stack([np.stack([g4[0], g4[0]]), np.stack([g4[2], g4[2]])])
    ref_p, ref_W = sat.sat_iteration(params, {"a": u4[:2], "b": u4[2:]},
                                     lambda p, f, spk, i: gmap[(spk, 0 if i is None else i)],
                                     num_comp=2)
    (bat_p, bat_W), t_bat = ctx.timed(lambda: sat.sat_iteration_batched(
        params, fb4, gb4, gamma_fn=lambda p, f: on(p, gb4_0)))
    bat_pc, bat_Wc = sat.sat_iteration_batched(host, fb4, gb4,
                                               gamma_fn=lambda p, f: on(p, gb4_0))
    e_bw = max(rel_err(bat_W[i].cpu(), ref_W[s].cpu()) for i, s in enumerate("ab"))
    e_bm = rel_err(bat_p.means.cpu(), ref_p.means.cpu())
    e_cw, e_cm = rel_err(bat_W.cpu(), bat_Wc), rel_err(bat_p.means.cpu(), bat_pc.means)
    print(f"AD: SAT host loop {t_sat:.3f} s, batched {t_bat:.3f} s on the host clock [{smi}]; "
          f"fit before -> after per speaker "
          f"{ {k: (round(a, 1), round(b, 1)) for k, (a, b) in fits.items()} }; "
          f"batched vs host loop: transforms rel err {e_bw:.2e} (bound 2e-4), means {e_bm:.2e} "
          f"(bound 2e-3); batched card vs CPU plain path {e_cw:.2e} / {e_cm:.2e} (same bounds)")
    check(all(after > before for before, after in fits.values()), "AD: SAT improves every speaker")
    check(e_bw <= 2e-4 and e_bm <= 2e-3, "AD: batched SAT equals the host loop")
    check(e_cw <= 2e-4 and e_cm <= 2e-3, "AD: batched SAT, card vs CPU")

    # MLLR regression classes (tests/test_mllr_regclass.py's three cases)
    Sg, Dg = 24, 4
    group = np.arange(Sg) % 2
    regc = []
    for seed, shifts_c, occ, n_leaves, min_occ in (
            (0, [[2.0, -1.0, 0.5, 1.5], [-1.5, 2.0, -0.5, -2.0]], np.full(Sg, 200.0), 2, 50.0),
            (1, [[1.0, 1, 1, 1], [-1.0, -1, -1, -1]], np.where(group == 0, 300.0, 2.0), 2, 50.0),
            (2, [[0.7, -0.2, 0.1, 0.4]] * 2, np.full(Sg, 200.0), 4, 10.0)):
        r = np.random.default_rng(seed)
        centers = np.asarray([[4.0, 4, 4, 4], [-4.0, -4, -4, -4]])
        mu = np.stack([centers[s % 2] + r.normal(0, 1.0, Dg) for s in range(Sg)])
        target = mu + np.asarray(shifts_c)[group]
        occ = occ.astype(np.float32)
        stats = (occ[:, None], (occ[:, None] * target)[:, None].astype(np.float32),
                 (occ[:, None] * (target ** 2 + 0.5))[:, None].astype(np.float32))
        out = []
        for d in (dev, "cpu"):
            p = gmm.GmmParams(mu[:, None, :].astype(np.float32), np.full((Sg, 1, Dg), 0.5),
                              np.zeros((Sg, 1))).to(d)
            acc = ml.GmmAccum(*(torch.as_tensor(a, device=d) for a in stats))
            tree = mllr.build_regression_tree(p, acc.occ, n_leaves=n_leaves)
            W_node, class_W = mllr.estimate_mllr_regclass(p, acc, tree, min_occ=min_occ)
            ad = mllr.apply_mllr_regclass(p, W_node, class_W).means[:, 0].cpu().numpy()
            glob = mllr.apply_mllr(p, mllr.estimate_mllr(p, acc)).means[:, 0].cpu().numpy()
            out.append((tree, class_W.cpu().numpy(), ad, glob))
        (tree, cls, ad, glob), (tree_c, cls_c, ad_c, _) = out
        regc.append(dict(err_class=float(np.abs(ad - target).max()),
                         err_global=float(np.abs(glob - target).max()),
                         classes=len(set(zip(group.tolist(), tree.leaf_of.tolist()))),
                         poor={int(c) for c in cls[group == 1]},
                         rich={int(c) for c in cls[group == 0]},
                         same=bool(np.array_equal(tree.leaf_of, tree_c.leaf_of)
                                   and np.array_equal(cls, cls_c)),
                         e_cpu=float(np.abs(ad - ad_c).max() / np.abs(ad_c).max())))
    print(f"AD: MLLR regression classes: two clusters err class {regc[0]['err_class']:.2e} "
          f"(gate < 2e-2) vs global {regc[0]['err_global']:.2f} (gate > 0.5); data-poor class "
          f"backs off to {regc[1]['poor']} (gate {{0}}), rich keeps {regc[1]['rich']}; uniform "
          f"shift over 4 leaves err {regc[2]['err_class']:.2e} (gate < 5e-2); card vs CPU trees "
          f"and classes equal {[c['same'] for c in regc]}, adapted means rel err "
          f"{max(c['e_cpu'] for c in regc):.2e} (bound 1e-4)")
    check(regc[0]["err_class"] < 2e-2 and regc[0]["err_global"] > 0.5
          and regc[0]["classes"] == 2, "AD: two-class MLLR")
    check(regc[1]["poor"] == {0} and regc[1]["rich"] != {0}, "AD: MLLR class back-off")
    check(regc[2]["err_class"] < 5e-2, "AD: MLLR classes under a uniform shift")
    check(all(c["same"] and c["e_cpu"] <= 1e-4 for c in regc), "AD: MLLR classes, card vs CPU")

    # VTLN (tests/test_vtln.py): the full vocabulary's phone task
    vtask = phone_task.PhoneTask(corpus.VOCAB, states_per_phone=2)
    vc = corpus.make_corpus(25, seed=0)
    vparams = trainer.train(vtask, [ctx.c1_feats(x) for _, x in vc], [ws for ws, _ in vc],
                            num_comp=2, iters=3, device=dev)
    warps = (0.85, 0.9, 0.95, 1.0, 1.05, 1.1, 1.15)
    plain = corpus.make_corpus(4, seed=200)
    phones = corpus.PHONES
    corpus.PHONES = {p: tuple(f * 1.1 for f in fs) for p, fs in phones.items()}
    try:
        warped = corpus.make_corpus(4, seed=200)    # every formant 10 % high
    finally:
        corpus.PHONES = phones
    est = {}
    for name, c in (("unwarped", plain), ("warped", warped)):
        args = ([x for _, x in c], [ws for ws, _ in c])
        est[name], secs = ctx.timed(lambda: ctx.counted(
            f"AD: VTLN {name} speaker ({len(warps)} warps x 4 utterances)",
            lambda: vtln.estimate_warp(vtask, vparams, *args, warps=warps),
            {"viterbi": len(warps) * 4}))
        est[name + " s"] = secs
    best_c, scores_c = vtln.estimate_warp(vtask, ctx.host_copy(vparams), [x for _, x in warped],
                                          [ws for ws, _ in warped], warps=warps)
    (b0, _), (b1, s1) = est["unwarped"], est["warped"]
    e_v = max(abs(s1[w] - scores_c[w]) / abs(scores_c[w]) for w in warps)
    print(f"AD: VTLN unwarped speaker -> {b0} (gate |w - 1| <= 0.05), warped x1.1 -> {b1} (gate "
          f"|w - 1/1.1| <= 0.051), its score gain over 1.0 {s1[b1] - s1[1.0]:.1f} (gate > 1); "
          f"{est['unwarped s']:.3f} / {est['warped s']:.3f} s on the host clock [{smi}]; card vs "
          f"CPU plain path warp {b1} / {best_c}, scores rel err {e_v:.2e} (bound 1e-3)")
    check(abs(b0 - 1.0) <= 0.05, "AD: VTLN keeps an unwarped speaker at 1.0")
    check(abs(b1 - 1.0 / 1.1) <= 0.051 and s1[b1] > s1[1.0] + 1.0, "AD: VTLN recovers the warp")
    check(b1 == best_c and e_v <= 1e-3, "AD: VTLN, card vs CPU")


# ---- FE, slice 8: the rest of the front end ---------------------------------
LOUDSPEAKER = np.array([0.0, -0.3, 0.05])  # the prompt's loudspeaker, 0.3 m from the array
PROMPT_GAIN = 4.0      # the free-field simulation has no 1/r: at 0.3 m against the talker's
                       # 2 m the prompt's echo is ~16 dB louder at equal source levels
PROMPT_MU = 0.2        # NLMS step of the voice-prompt canceller: the talker barges in over
                       # the prompt and misadjusts the filter, which a step of 0.2 undoes
                       # within ~0.3 s
SOHN_THRESHOLD = 1.0   # on noise of a known PSD Sohn's decision-directed mean ratio sits
                       # just above 0, so the default threshold 0 fires on silence
SAD_MARGIN = 1e-5      # a card decision may differ from the CPU's only this close to its threshold


def stage_ms(fn, iters: int = 3) -> float:
    """Device ms of one fn() (CUDA events over `iters` calls after a warm-up)."""
    return cuda_ms(fn, iters=iters, warmup=1)


def busy_share(fn, ms: float) -> float:
    """The share of fn()'s `ms` in which the card ran a kernel (profiler)."""
    return profile_frames(fn, 1)[0] / 1e3 / ms


def energy_margins(P_frames: np.ndarray, threshold_db: float = 6.0) -> np.ndarray:
    """|log power - (floor + threshold)| of each frame: `sad.energy_vad`'s
    floor recurrence in float32 numpy, the arithmetic of the JAX scan."""
    logp = (10.0 * np.log10(np.maximum(P_frames, 1e-12))).astype(np.float32)
    floor = logp[0]
    out = np.empty_like(logp)
    for t, lp in enumerate(logp):
        if lp < floor:
            floor = np.float32(0.9) * floor + np.float32(0.1) * lp
        else:
            floor = floor + np.float32(0.05)
        out[t] = abs(lp - (floor + np.float32(threshold_db)))
    return out


def same_decisions(name, dec, dec_cpu, margin_cpu, hangover=8) -> int:
    """Card decisions against the CPU's: every differing frame must lie
    within the hangover after a frame whose CPU margin to the threshold is
    under SAD_MARGIN.  → the number of frames that differ."""
    diff = np.flatnonzero(dec != dec_cpu)
    near = np.flatnonzero(margin_cpu < SAD_MARGIN)
    ok = all(((t - near >= 0) & (t - near <= hangover)).any() for t in diff)
    check(ok, f"FE1: {name} decisions differ from the CPU's away from the threshold "
              f"(frames {diff[:10].tolist()})")
    return len(diff)


def phase_fe1(ctx):
    """FE1, a barge-in front end at config 2's width: 64-mic circular 0.20 m
    array, 8 s, M = 256 m = 4 r = 2.  Returns the recording for FE3."""
    from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig
    from dsr_tpu_torch.ops import aec, lpc, sad
    from dsr_tpu_torch.ops import features as ft
    from dsr_tpu_torch.ops import filterbank as fb
    from dsr_tpu_torch.pipeline import DsrPipeline
    from dsr_tpu_torch.utils import objective, room

    dev, cfg, smi = ctx.dev, ctx.cfg, ctx.smi
    S = int(8 * SR)
    rng = np.random.default_rng(21)
    geo = ArrayGeometry.circular(64, 0.20)
    pos = np.asarray(geo.positions)
    bursts = [(1.5, 3.0), (4.5, 6.5)]                       # seconds the talker speaks
    talking = np.zeros(S, bool)
    for a, b in bursts:
        talking[int(a * SR):int(b * SR)] = True
    talk = rng.standard_normal(S) * talking
    prompt = PROMPT_GAIN * rng.standard_normal(S)
    t0 = time.perf_counter()
    x = (room.simulate(talk, pos, SOURCE, SR, snr_db=20.0, rng=rng)
         + room.simulate(prompt, pos, LOUDSPEAKER, SR, snr_db=None, rng=rng))
    sim_s = time.perf_counter() - t0
    w = DsrPipeline(fb=cfg, geometry=geo, beamformer=BeamformerConfig(kind="mvdr"),
                    device=dev).weights(SOURCE)
    hamming = np.hamming(400).astype(np.float32)

    def chain(x_, prompt_, w_):
        """The barge-in chain on the device of its inputs."""
        win = torch.as_tensor(hamming, device=x_.device)
        Y = fb.analysis_beamform(x_, w_, cfg)                      # (T, K), row 3
        F = fb.analysis(prompt_, cfg)                              # row 1
        E, _ = aec.cancel_voice_prompt(Y, F, taps=4, mu=PROMPT_MU)
        Ek, _ = aec.kalman_aec(Y, F, taps=4)
        P = E.abs() ** 2
        noise = P[:20].mean(0)
        dec, llr = sad.sohn_vad(P, noise, threshold=SOHN_THRESHOLD)
        Pss = ft.spectral_subtraction(P, noise)
        y = fb.synthesis(E, cfg, S)                                # row 4
        frames = y.unfold(-1, 400, 160) * win                     # (798, 400)
        pfr = (frames ** 2).mean(-1)
        edec = sad.energy_vad(pfr)
        c = lpc.warped_mvdr_cepstra(frames, order=30, num_bins=129, num_cepstra=13)
        feats = ft.splice(ft.add_deltas(c), 3, 3)
        return dict(Y=Y, F=F, E=E, Ek=Ek, P=P, dec=dec, llr=llr, Pss=Pss, y=y, frames=frames,
                    pfr=pfr, edec=edec, c=c, feats=feats)

    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    pd = torch.as_tensor(prompt, dtype=torch.float32, device=dev)
    chain(xd, pd, w)                                                 # warm-up
    out, chain_s = ctx.timed(lambda: ctx.counted(
        "FE1: barge-in front end (64 ch x 8 s, MVDR, prompt AEC, SAD, warped MVDR)",
        lambda: chain(xd, pd, w), {"analysis_beamform": 1, "analysis": 1, "synthesis": 1}))
    t0 = time.perf_counter()
    segs = sad.segments_from_vad(out["dec"])
    segs_s = time.perf_counter() - t0
    ref = chain(torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(prompt,
                                                                         dtype=torch.float32),
                w.cpu())
    T, K = ref["Y"].shape
    check(out["y"].shape == (S,) and out["feats"].shape == (798, 7 * 39) and T == 1015
          and K == 129, "FE1: shapes")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()), "FE1: finite outputs")
    errs = {k: rel_err(out[k].cpu(), ref[k]) for k in ("Y", "F", "E", "Ek", "Pss", "y")}
    errs_c = {k: rel_err(out[k].cpu(), ref[k]) for k in ("c", "feats")}
    print(f"FE1 card vs CPU plain path: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + " (gate 1e-4); " + ", ".join(f"{k} {v:.2e}" for k, v in errs_c.items())
          + " (gate 1e-3)")
    check(max(errs.values()) <= 1e-4, "FE1: subbands and waveform, card vs CPU")
    check(max(errs_c.values()) <= 1e-3, "FE1: cepstra, card vs CPU")
    dec, edec = out["dec"].cpu().numpy(), out["edec"].cpu().numpy()
    n_sohn = same_decisions("sohn_vad", dec, ref["dec"].numpy(),
                            np.abs(ref["llr"].numpy() - SOHN_THRESHOLD))
    n_energy = same_decisions("energy_vad", edec, ref["edec"].numpy(),
                              energy_margins(ref["pfr"].numpy()))
    segs_cpu = sad.segments_from_vad(ref["dec"])
    print(f"FE1 decisions differing from the CPU's (each within the hangover after a frame "
          f"under {SAD_MARGIN:g} of the threshold): sohn {n_sohn}, energy {n_energy}; segments "
          f"{segs} (CPU {segs_cpu})")
    check(n_sohn > 0 or segs == segs_cpu, "FE1: segments, card vs CPU")

    # SAD against the talker's bursts: frames well inside a burst, and
    # silent frames away from a burst by the hangover and the frame's span
    t_sb = (np.arange(T) * cfg.D - (cfg.L - cfg.D) + cfg.L // 2) / SR   # subband frame centres
    t_fr = (np.arange(len(edec)) * 160 + 200) / SR                       # 400 / 160 frames

    def regions(t, span):
        inside = np.zeros(len(t), bool)
        silent = np.ones(len(t), bool)
        for a, b in bursts:
            inside |= (t > a + span) & (t < b - span)
            silent &= (t < a - span) | (t > b + span + 0.15)
        return inside, silent & (t > span)

    gates = {}
    for name, d, t, span in (("sohn", dec, t_sb, 0.07), ("energy", edec, t_fr, 0.03)):
        inside, silent = regions(t, span)
        gates[name] = (float(d[inside].mean()), float(d[silent].mean()))
        check(gates[name][0] >= 0.9 and gates[name][1] <= 0.2,
              f"FE1: {name} VAD hits {gates[name][0]:.3f} (>= 0.9), false alarms "
              f"{gates[name][1]:.3f} (<= 0.2)")
    inside, silent = regions(t_sb, 0.07)
    Yp = (out["Y"].abs() ** 2)[torch.as_tensor(silent, device=dev)].sum()
    erle = {k: float(10 * torch.log10(Yp / (out[k].abs() ** 2)[
        torch.as_tensor(silent, device=dev)].sum())) for k in ("E", "Ek")}
    y0 = fb.synthesis(out["Y"], cfg, S).cpu().numpy().astype(np.float64)   # without AEC
    y1 = out["y"].cpu().numpy().astype(np.float64)
    t0 = time.perf_counter()
    scores = {k: (getattr(objective, k)(y1, talk), getattr(objective, k)(y0, talk))
              for k in ("si_sdr", "segmental_snr", "fw_segmental_snr")}
    obj_s = time.perf_counter() - t0
    print(f"FE1: recording simulated in {sim_s:.2f} s on the host; chain {chain_s * 1e3:.1f} ms "
          f"on the host clock; ERLE over the talker-silent frames: NLMS prompt canceller "
          f"{erle['E']:.2f} dB, Kalman {erle['Ek']:.2f} dB; SAD (hits, false alarms): "
          + ", ".join(f"{k} ({h:.3f}, {f:.3f})" for k, (h, f) in gates.items())
          + " (gates >= 0.9, <= 0.2); with / without AEC: "
          + ", ".join(f"{k} {a:.2f} / {b:.2f} dB" for k, (a, b) in scores.items())
          + f"; segments_from_vad {segs_s * 1e3:.2f} ms, objective measures {obj_s:.2f} s "
          f"on the host")

    # each stage on the card's clock; the frame loops' device-busy share
    Y, F, E, P = out["Y"], out["F"], out["E"], out["P"]
    noise = P[:20].mean(0)
    frames = out["frames"]
    r = lpc.warped_autocorr(frames, 30)
    stages = {
        "analysis_beamform": lambda: fb.analysis_beamform(xd, w, cfg),
        "analysis (prompt)": lambda: fb.analysis(pd, cfg),
        "cancel_voice_prompt": lambda: aec.cancel_voice_prompt(Y, F, taps=4, mu=PROMPT_MU),
        "kalman_aec": lambda: aec.kalman_aec(Y, F, taps=4),
        "sohn_vad": lambda: sad.sohn_vad(P, noise, threshold=SOHN_THRESHOLD),
        "spectral_subtraction": lambda: ft.spectral_subtraction(P, noise),
        "synthesis": lambda: fb.synthesis(E, cfg, S),
        "energy_vad": lambda: sad.energy_vad(out["pfr"]),
        "warped_autocorr": lambda: lpc.warped_autocorr(frames, 30),
        "levinson": lambda: lpc.levinson(r),
        "warped_mvdr_cepstra": lambda: lpc.warped_mvdr_cepstra(frames, order=30),
        "add_deltas + splice": lambda: ft.splice(ft.add_deltas(out["c"]), 3, 3),
    }
    ms = {k: stage_ms(fn) for k, fn in stages.items()}
    loops = ("cancel_voice_prompt", "kalman_aec", "sohn_vad", "energy_vad", "levinson",
             "warped_autocorr", "warped_mvdr_cepstra")
    busy = {k: busy_share(stages[k], ms[k]) for k in loops}
    print(f"FE1 stages (ms, CUDA events) [{smi}]: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    print(f"FE1 device-busy share (profiler) [{smi}]: "
          + ", ".join(f"{k} {v:.3f}" for k, v in busy.items())
          + f"; warped_autocorr {2 * 30 * 798 * 400 * 400 / ms['warped_autocorr'] / 1e6:.1f} "
          f"GFLOP/s ({2 * 30 * 798 * 400 * 400 / 1e9:.2f} GFLOP)")
    return x


def phase_fe2(ctx):
    """FE2: configs without a shipped prototype, designed by `get_prototypes`."""
    from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
    from dsr_tpu_torch.ops import filterbank as fb
    from dsr_tpu_torch.ops.cuda import filterbank as cfb
    from dsr_tpu_torch.pipeline import DsrPipeline
    from dsr_tpu_torch.utils import design

    dev, smi = ctx.dev, ctx.smi
    rng = np.random.default_rng(22)
    x8 = torch.as_tensor(rng.standard_normal((8, int(4 * SR))).astype(np.float32), device=dev)
    S8 = x8.shape[-1]
    for M in (128, 512):
        c = FilterbankConfig(M=M, m=4, r=2)
        check(not (design.PROTOTYPE_DIR / f"proto-M{M}-m4-r2-b1-j2.npz").exists(),
              f"FE2: M={M} has no shipped prototype")
        t0 = time.perf_counter()
        hf, gf, delay = design.get_prototypes(c)
        design_s = time.perf_counter() - t0
        pr_db = design.pr_error_db(hf, gf, M, 4, 2)
        A, y = ctx.counted(f"FE2: analysis -> synthesis M={M} m=4 r=2 (8 ch x 4 s)",
                           lambda: (lambda A_: (A_, fb.synthesis(A_, c, S8)))(fb.analysis(x8, c)),
                           {"analysis": 1, "synthesis": 1})
        hf_t, gf_t, _ = fb.prototype_tensors(c, dev)
        e_a = rel_err(A, cfb.analysis_plain(x8, hf_t, M, c.r, A.shape[-2]))
        e_s = rel_err(y, cfb.synthesis_plain(A, gf_t, M, c.r, c.L - c.D + delay, S8))
        rt_db = 20 * float(torch.log10((y - x8).abs().max() / x8.abs().max()))
        line = (f"FE2 M={M} m=4 r=2 designed in {design_s:.2f} s on the host, PR error "
                f"{pr_db:.1f} dB; kernels vs twins: analysis {e_a:.2e}, synthesis {e_s:.2e} "
                f"(gate {TOL:g}); reconstruction {rt_db:.1f} dB (gate < -50)")
        check(e_a <= TOL and e_s <= TOL, f"FE2 M={M}: kernels against their twins")
        check(rt_db < -50.0, f"FE2 M={M}: reconstruction")
        if M == 512:
            geo = ArrayGeometry.circular(64, 0.20)
            x64 = torch.as_tensor(rng.standard_normal((geo.num_channels, int(8 * SR))).astype(
                np.float32), device=dev)
            w = DsrPipeline(fb=c, geometry=geo, beamformer=BeamformerConfig(kind="mvdr"),
                            device=dev).weights(SOURCE)
            Yb = ctx.counted("FE2: analysis_beamform M=512 (64 ch x 8 s, MVDR)",
                             lambda: fb.analysis_beamform(x64, w, c), {"analysis_beamform": 1})
            e_b = rel_err(Yb, cfb.analysis_beamform_plain(x64, hf_t, w, M, c.r, Yb.shape[0]))
            check(e_b <= TOL, "FE2 M=512: the fused kernel against its twin")
            line += (f"; analysis_beamform 64 ch x 8 s {e_b:.2e}, "
                     f"{stage_ms(lambda: fb.analysis_beamform(x64, w, c), 10):.4f} ms")
        print(line + f"; analysis {stage_ms(lambda: fb.analysis(x8, c), 10):.4f} ms, synthesis "
              f"{stage_ms(lambda: fb.synthesis(A, c, S8), 10):.4f} ms [{smi}]")


def phase_fe3(ctx, x):
    """FE3: the cosine-modulated and PR-FFT banks and the FIR filters on
    FE1's 64 ch x 8 s recording, card against the CPU plain path."""
    from dsr_tpu_torch.ops import cmfb, convolution, prfft

    dev, smi = ctx.dev, ctx.smi
    S = x.shape[-1]
    xc = torch.as_tensor(x, dtype=torch.float32)
    xd = xc.to(dev)
    d = cmfb.design(64, 8)
    L = d.ha.shape[1]
    rng = np.random.default_rng(23)
    h = (rng.standard_normal(4096) * np.exp(-np.arange(4096) / 600.0)).astype(np.float32)
    cases = {
        "cmfb M=64 m=8": (lambda x_: cmfb.synthesis(cmfb.analysis(x_, d), d, S), 2 * L),
        "prfft M=512 D=256": (lambda x_: prfft.synthesis(prfft.analysis(x_, 512, 256), 512, 256,
                                                         S), 0),
        "prfft M=512 D=128": (lambda x_: prfft.synthesis(prfft.analysis(x_, 512, 128), 512, 128,
                                                         S), 0),
        "overlap_add 4096 taps": (lambda x_: convolution.overlap_add(x_, h, 4096), None),
        "overlap_save 4096 taps": (lambda x_: convolution.overlap_save(x_, h, 4096), None),
    }
    parts = []
    for name, (fn, edge) in cases.items():
        y = fn(xd)
        y_cpu = fn(xc)
        e = rel_err(y.cpu(), y_cpu)
        check(bool(torch.isfinite(y).all()) and e <= 1e-4, f"FE3 {name}: card vs CPU {e:.2e}")
        if edge is None:
            rec = ""
        else:
            seg = slice(edge, S - edge)
            rec_db = 20 * float(torch.log10((y[:, seg] - xd[:, seg]).abs().max()
                                            / xd.abs().max()))
            rec = f", reconstruction {rec_db:.1f} dB"
        parts.append(f"{name} {e:.2e}{rec}, {stage_ms(lambda: fn(xd)):.3f} ms")
    e_os = rel_err(cases["overlap_save 4096 taps"][0](xd), cases["overlap_add 4096 taps"][0](xd))
    print(f"FE3 64 ch x 8 s, card vs CPU plain path (gate 1e-4), analysis -> synthesis: "
          + "; ".join(parts) + f"; overlap-save vs overlap-add {e_os:.2e} [{smi}]")


def phase_fe4(ctx):
    """FE4: the modal beamformer of a 32-mic open sphere (radius 4.2 cm, order 3)."""
    from dsr_tpu_torch.config import FilterbankConfig
    from dsr_tpu_torch.ops import beamforming as bf
    from dsr_tpu_torch.ops import filterbank as fb
    from dsr_tpu_torch.ops import modal
    from dsr_tpu_torch.utils import room

    dev, smi, cfg = ctx.dev, ctx.smi, ctx.cfg
    radius, order = 0.042, 3
    dirs = modal.sphere_mic_dirs(32)
    look = np.array([np.pi / 2, 0.0])
    w2 = modal.modal_weights(order, 2.0, dirs, look, reg=1e-3)     # the JAX test's gate
    on = abs(np.conj(w2) @ modal.plane_wave_pressure(order, 2.0, dirs, look))
    off = [abs(np.conj(w2) @ modal.plane_wave_pressure(order, 2.0, dirs, np.array([np.pi / 2, az])))
           for az in (1.2, 2.2, 3.0)]
    check(on > 0.5 and max(off) < 0.6 * on, "FE4: modal weights at ka = 2 steer")
    t0 = time.perf_counter()
    W = modal.modal_weights_subband(order, radius, cfg.M, SR, dirs, look)
    w_s = time.perf_counter() - t0
    u = np.stack([np.sin(dirs[:, 0]) * np.cos(dirs[:, 1]), np.sin(dirs[:, 0]) * np.sin(dirs[:, 1]),
                  np.cos(dirs[:, 0])], axis=1)
    mics = radius * u
    rng = np.random.default_rng(24)
    S = int(4 * SR)
    azs = (0.0, 1.2, 2.2, 3.0)                                       # the look direction first
    x = np.stack([room.simulate(rng.standard_normal(S), mics,
                                5.0 * np.array([np.cos(az), np.sin(az), 0.0]), SR, snr_db=None)
                  for az in azs]).astype(np.float32)                  # (4, 32, S)

    def chain(x_, W_):
        return fb.synthesis(bf.apply_weights(fb.analysis(x_, cfg), W_), cfg, S)

    Wd = torch.as_tensor(W, device=dev)
    xd = torch.as_tensor(x, device=dev)
    y = ctx.counted("FE4: modal beamformer (4 sources x 32 ch x 4 s)", lambda: chain(xd, Wd),
                    {"analysis": 1, "synthesis": 1})
    y_cpu = chain(torch.as_tensor(x), torch.as_tensor(W))
    e = rel_err(y.cpu(), y_cpu)
    check(bool(torch.isfinite(y).all()) and e <= 1e-4, f"FE4: card vs CPU {e:.2e}")
    p = (y.double() ** 2).mean(-1).cpu().numpy()
    print(f"FE4 modal 32-mic sphere r=4.2 cm order 3: weights (129 bins) {w_s:.3f} s on the "
          f"host; ka=2 gains on {on:.3f}, off {[round(float(g), 3) for g in off]} (gates > 0.5, "
          f"< 0.6 x on); card vs CPU {e:.2e} (gate 1e-4); broadband output power on-look / "
          f"off-look (az 1.2, 2.2, 3.0): "
          + ", ".join(f"{10 * np.log10(p[0] / p[i]):.2f} dB" for i in (1, 2, 3))
          + f"; chain {stage_ms(lambda: chain(xd, Wd)):.3f} ms [{smi}]")


def phase_frontend(ctx):
    """FE, slice 8: FE1-FE4; prints the launches the phase added."""
    before = dict(ctx.counts)
    x = phase_fe1(ctx)
    phase_fe2(ctx)
    phase_fe3(ctx, x)
    phase_fe4(ctx)
    print(f"FE launches: { {k: v - before[k] for k, v in ctx.counts.items() if v != before[k]} }")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dsr_tpu_torch.asr import lvcsr, phone_task, smallvocab
    from dsr_tpu_torch.asr import path as apath
    from dsr_tpu_torch.asr.am import gmm
    from dsr_tpu_torch.asr.decoder import lattice
    from dsr_tpu_torch.asr.decoder import wfst_decoder as wd
    from dsr_tpu_torch.asr.fsm import hclg, lm
    from dsr_tpu_torch.asr.fsm.packed import pack
    from dsr_tpu_torch.asr.train import mmi, trainer
    from dsr_tpu_torch.asr.decoder import split_decoder as sd
    from dsr_tpu_torch.asr.decoder import topk_decoder as tk
    from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
    from dsr_tpu_torch.entry import entry
    from dsr_tpu_torch.ops import beamforming as bf
    from dsr_tpu_torch.ops import dereverb as der
    from dsr_tpu_torch.ops import features as ft
    from dsr_tpu_torch.ops import filterbank as fb
    from dsr_tpu_torch.ops import tde
    from dsr_tpu_torch.ops import tracking as trk
    from dsr_tpu_torch.ops.cuda import build
    from dsr_tpu_torch.ops.cuda import filterbank as cfb
    from dsr_tpu_torch.ops.cuda import gsc as cgsc
    from dsr_tpu_torch.ops.cuda import select as csel
    from dsr_tpu_torch.ops.cuda import steering as csteer
    from dsr_tpu_torch.ops.cuda import viterbi as cvit
    from dsr_tpu_torch.pipeline import DsrPipeline, StreamingRecognizer
    from dsr_tpu_torch.utils import corpus, design
    from dsr_tpu_torch.utils.metrics import WerScorer, edit_distance

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
            kernel_name = ""
            for line in log.splitlines():
                if "Compiling entry function" in line:   # the kernel (and its template flags)
                    found = re.search(r"\d+([a-z_]+_kernel)(I(?:L[a-z]+\d+E)+)?", line)
                    kernel_name = "".join(found.groups("")) if found else line.strip()
                elif "registers" in line or "spill" in line or "smem" in line:
                    print(f"    {kernel_name}: {line.strip()}")

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

    def compare(name, label, kernel, plain, nbytes, flops, library=None, tol=TOL, iters=20):
        out = kernel()
        ref = plain()
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        ms = cuda_ms(kernel, iters=iters, warmup=min(3, iters))
        plain_ms = cuda_ms(plain, iters=iters, warmup=min(3, iters))
        lib_ms = cuda_ms(library) if library is not None else None
        b_ms, b_by = bound(nbytes, flops)
        print(f"{name:18s} {label:34s} rel err {err:.2e} (bound {tol:.0e})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms ({ms / lib_ms:.2f}x)'}  bound "
              f"{b_ms:.4f} ms ({b_by})  [{smi}]")
        check(err <= tol, f"{name} {label}: rel err {err:.3e} > {tol}")
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

    def synthesis_case(c, A, g, out_len, label, main, iters=20, start=None):
        C, T, K = A.shape
        start = c.L - c.D if start is None else start
        # the frames the output samples read: t_lo .. the last sample's frame
        t_lo = max(0, start // c.D - c.L // c.D + 1)
        rows = min(T - 1, (start + out_len - 1) // c.D) - t_lo + 1
        res = compare("synthesis", label,
                      lambda: cfb.synthesis(A, g, c.M, c.m, c.r, start, out_len),
                      lambda: cfb.synthesis_plain(A, g, c.M, c.r, start, out_len),
                      8 * C * rows * K + 4 * c.L + 4 * C * out_len,
                      C * (rows * rfft_flops(c.M) + out_len * 2 * (c.L // c.D)), iters=iters)
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
    # m r = 32,768: no tile fits a block; every frame's inverse FFT through
    # device memory, then the overlap-add; random prototypes, a 2,000-sample
    # signal
    c4k = FilterbankConfig(M=4096, m=8, r=4096)
    h4k, g4k = (torch.as_tensor(rng.standard_normal(c4k.L).astype(np.float32) / 16, device=dev)
                for _ in range(2))
    x4k = signal(1, 2000 / SR)
    A4k = cfb.analysis_plain(x4k, h4k, c4k.M, c4k.r, fb.num_frames(2000, c4k))
    synthesis_case(c4k, A4k, g4k, 2000, "1 ch x 2,000 samples M=4096 m=8 r=4096", False,
                   iters=3)
    del A4k
    torch.cuda.empty_cache()
    # random spectra, whose DC and Nyquist bins have imaginary parts, from
    # 5 samples past the default start; also at the odd M = 127 (r = 1).
    # irfft ignores those parts (torch on the CPU, numpy, the JAX package),
    # and so does the kernel: its output equals, bit for bit, its output for
    # the same spectra with them zeroed, which is held to the twin (on the
    # card the twin's irfft is cuFFT's, which at some shapes does not ignore
    # them)
    for c in (cfg, FilterbankConfig(M=127, m=2, r=1)):
        A_r = torch.view_as_complex(torch.as_tensor(
            rng.standard_normal((2, 200, c.num_bins, 2)).astype(np.float32), device=dev))
        check(bool((A_r[..., 0].imag != 0).all() and (A_r[..., -1].imag != 0).all()),
              "random spectra with imaginary DC and Nyquist")
        A_h = A_r.clone()
        A_h[..., 0] = A_h[..., 0].real
        if c.M % 2 == 0:
            A_h[..., -1] = A_h[..., -1].real
        g_r = torch.as_tensor(rng.standard_normal(c.L).astype(np.float32) / 16, device=dev)
        start_r = c.L - c.D + 5
        S_r = 199 * c.D + c.L - start_r
        check(torch.equal(cfb.synthesis(A_r.contiguous(), g_r, c.M, c.m, c.r, start_r, S_r),
                          cfb.synthesis(A_h.contiguous(), g_r, c.M, c.m, c.r, start_r, S_r)),
              f"synthesis M={c.M}: the imaginary DC and Nyquist parts change the output")
        synthesis_case(c, A_h.contiguous(), g_r, S_r,
                       f"2 ch random spectra M={c.M} m={c.m} r={c.r}, start L-D+5", False,
                       start=start_r)

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

    # configs whose direct-IDFT synthesis (before its FFT) exceeded the
    # card's shared-memory opt-in and took its IDFT in slabs of bins; random
    # prototypes as tests/_torch_parity.py's filterbank_case makes them;
    # 4 ch x 1 s, each kernel timed
    for M, m, r in ((512, 4, 4), (1024, 4, 2), (768, 4, 1), (768, 4, 2)):
        c = FilterbankConfig(M=M, m=m, r=r)
        if (M, r) != (768, 2):   # the analysis also at 8 ch x 1 s, its own inputs
            r8 = np.random.default_rng(M + r)
            analysis_case(c, torch.as_tensor(r8.standard_normal((8, 16000)).astype(np.float32),
                                             device=dev),
                          torch.as_tensor(r8.standard_normal(c.L).astype(np.float32) / 16,
                                          device=dev), f"8 ch x 1 s M={M} m={m} r={r}", False)
        h, g = (torch.as_tensor(rng.standard_normal(c.L).astype(np.float32) / 16, device=dev)
                for _ in range(2))
        xs = signal(4, 1.0)
        C, S = xs.shape
        T = fb.num_frames(S, c)
        Kc = c.num_bins
        label = f"4 ch x 1 s M={M} m={m} r={r}"
        analysis_case(c, xs, h, label, False)
        ws = torch.view_as_complex(torch.as_tensor(
            rng.standard_normal((Kc, C, 2)).astype(np.float32), device=dev)).contiguous()
        compare("analysis_beamform", label,
                lambda: cfb.analysis_beamform(xs, h, ws, M, m, r, T),
                lambda: cfb.analysis_beamform_plain(xs, h, ws, M, r, T),
                4 * (C * S + c.L) + 8 * Kc * C + 8 * T * Kc,
                C * T * (2 * c.L + rfft_flops(M) + 8 * Kc))
        synthesis_case(c, cfb.analysis_plain(xs, h, M, r, T), g, S, label, False)

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
                           (134656, 512, "dense triphone 512x263"),
                           (269312, 1024, "dense triphone 1024x263")):
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

    # the select kernel's lattice mode against its twin, bitwise (the 1-best
    # triple also against the 1-best kernel): the pools above, nlat 1, 3, 4
    # and 8, beams 40 and 1e9; and kcap 155 with nlat 512, more alternates
    # than any run holds (tests/test_adapt_mmi_lattice.py's exhaustive case)
    lat_cases = [(N, kcap, nlat, beam) for N, kcap in ((2304, 256), (12032, 256),
                                                        (134656, 512), (269312, 1024))
                 for nlat in (1, 3, 4, 8) for beam in (40.0, 1e9)] + [(4805, 155, 512, 1e9)]
    n_alt, pool_ms = 0, []
    for N, kcap, nlat, beam in lat_cases:
        args = select_case(N, kcap, beam, 7 * N + nlat + int(beam))
        out = csel.recombine_topk(*args, kcap, nlat)
        ref = csel.recombine_topk_plain(*args, kcap, nlat)
        one = csel.recombine_topk(*args, kcap)
        torch.cuda.synchronize()
        same = (all(torch.equal(bits(o), bits(r)) for o, r in zip(out, ref))
                and all(torch.equal(bits(o), bits(r)) for o, r in zip(out[:3], one)))
        check(same, f"select lattice mode N={N} kcap={kcap} nlat={nlat} beam={beam}: not "
                    "bitwise equal to its twin and the 1-best kernel")
        n_alt += int((out[4][..., 1:] >= 0).sum())
        if nlat == 4 and beam == 40.0:   # each pool's time, against the 1-best mode's
            pool_ms.append(f"N={N} kcap={kcap}: lattice " + " / ".join(
                f"{cuda_ms(fn, iters=3, warmup=1):.4f}" for fn in (
                    lambda: csel.recombine_topk(*args, kcap, nlat),
                    lambda: csel.recombine_topk(*args, kcap),
                    lambda: csel.recombine_topk_plain(*args, kcap, nlat))) + " ms")
    print(f"select lattice mode nlat 4 beam 40, U=8, kernel / the 1-best kernel / plain: "
          + "; ".join(pool_ms) + f"  [{smi}]")
    print(f"select lattice mode: {len(lat_cases)} cases (U=8; N = 2,304 / 12,032 / 134,656 / "
          f"269,312 at kcap 256 / 256 / 512 / 1,024, nlat 1 / 3 / 4 / 8, beams 40 and 1e9; N = "
          f"4,805 kcap 155 nlat 512) bitwise equal to the twin, 1-best triple equal to the "
          f"1-best kernel's; {n_alt} live alternates beyond column 0")
    N, kcap, nlat = 12032, 256, 4        # the lattice decode's pool (dense, a_max 47)
    args = select_case(N, kcap, 40.0, 12032 + 4)
    out = csel.recombine_topk(*args, kcap, nlat)
    ref = csel.recombine_topk_plain(*args, kcap, nlat)
    torch.cuda.synchronize()
    check(all(torch.equal(bits(o), bits(r)) for o, r in zip(out, ref)),
          "select lattice mode at the timed shape: not bitwise equal to its twin")
    err = max(float((o.double() - r.double()).abs().max()) for o, r in zip(out, ref))
    ms = cuda_ms(lambda: csel.recombine_topk(*args, kcap, nlat))
    ms_one = cuda_ms(lambda: csel.recombine_topk(*args, kcap))
    plain_ms = cuda_ms(lambda: csel.recombine_topk_plain(*args, kcap, nlat))
    # 12 bytes in per candidate; out per slot its dst and nlat (score, arc)
    # pairs, column 0 the winner (the Pallas lattice mode's outputs; the
    # kernel also writes the 1-best score and arc, 8 bytes a slot more);
    # two comparisons per candidate
    b_ms, b_by = bound(8 * (12 * N + (4 + 8 * nlat) * kcap), 2 * 8 * N)
    print(f"select lattice U=8 N={N} kcap={kcap} nlat={nlat} beam=40: bitwise equal to the twin "
          f"(max |diff| {err:g} over the five outputs); kernel {ms:.4f} ms, the 1-best mode on "
          f"the same candidates {ms_one:.4f} ms; plain {plain_ms:.4f} ms  library n/a  bound "
          f"{b_ms:.5f} ms ({b_by})  [{smi}]")
    record["select_lattice"] = dict(max_abs_err=err, rel_err=0.0, ms=ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # the select kernel's edge cases, both modes, bitwise against the twin
    # (U = 8): every candidate at NEG + NEG under a beam of 1e31 (the kept
    # values below NEG come after the NEG slots), with and without
    # duplicate dsts; a single dst; all dsts distinct; kcap above N; 1,500
    # identical candidates (the decoders' dead tokens repeat their arcs)
    # filling one bucket past the sort buffer
    re_ = np.random.default_rng(11)
    edges = []
    for name, N, kcap, ndst, neg, beam, nlat in (
            ("NEG + NEG, duplicates, beam 1e31", 12032, 256, 500, True, 1e31, 4),
            ("NEG + NEG, distinct dsts, beam 1e31", 2304, 256, None, True, 1e31, 4),
            ("a single dst", 12032, 64, 1, False, 40.0, 8),
            ("a single dst, beam 1e31", 134656, 64, 1, False, 1e31, 8),
            ("all dsts distinct", 12032, 256, None, False, 40.0, 4),
            ("kcap above N", 100, 256, 60, False, 1e9, 4),
            ("kcap above N, the table in device memory", 13000, 16000, 4000, False, 1e9, 4),
            ("1,500 identical candidates", 3000, 64, 300, False, 1e9, 512)):
        c = (np.round(re_.standard_normal((8, N)) * 40) / 4).astype(np.float32)
        if neg:
            c[:] = np.float32(NEG) + np.float32(NEG)
        d = (np.stack([re_.permutation(N) for _ in range(8)]) if ndst is None
             else re_.integers(0, ndst, (8, N))).astype(np.int32)
        a = re_.permutation(8 * N).reshape(8, N).astype(np.int32)
        if ndst == 300:
            c[:, :1500], d[:, :1500], a[:, :1500] = 500.0, 3, 7
        args = [torch.as_tensor(v, device=dev) for v in (c, d, a, np.full(8, beam, np.float32))]
        same = all(torch.equal(bits(o), bits(r_)) for mode in (0, nlat) for o, r_ in zip(
            csel.recombine_topk(*args, kcap, mode), csel.recombine_topk_plain(*args, kcap, mode)))
        torch.cuda.synchronize()
        check(same, f"select edge case {name}: not bitwise equal to its twin")
        edges.append(name)
    print(f"select edge cases, both modes, U=8, bitwise equal to the twin: {'; '.join(edges)}")

    # the GSC kernel against its twin: U utterances of 8 ch x 1000 frames x
    # 129 bins, each with the DS weights and blocking matrix of its own source
    N8, T_g = 8, 1000
    POS8 = np.asarray(ArrayGeometry.circular(N8, 0.10).positions)
    gsc_args = dict(mu=0.05, eps=1e-6, cap=10.0)

    def gsc_case(U, seed, POS, T=T_g):
        N = len(POS)
        r = np.random.default_rng(seed)
        X = torch.view_as_complex(torch.as_tensor(
            r.standard_normal((U, N, T, K, 2)).astype(np.float32), device=dev))
        srcs = r.uniform(-2.0, 2.0, (U, 3)) + np.array([0.0, 2.5, 0.0])
        taus = np.stack([design.steering_delays(POS, p_, 343.0, SR) / SR for p_ in srcs])
        v = bf.steering_vectors(torch.as_tensor(taus.astype(np.float32), device=dev), cfg.M, SR)
        return X.contiguous(), bf.ds_weights(v).contiguous(), bf.blocking_matrix(v).contiguous()

    def gsc_chain_cycles(N):
        """The chain's dependent latency a frame, estimated from its
        instructions (csrc/gsc.cu gsc_chain_kernel), not measured: from the
        last frame's scale, y (an FFMA, ~4 cycles), g y (~4), the update (a
        multiply and two FFMAs, ~12), |u|^2 in two partial sums of ceil(E /
        2) entries, two dependent FFMAs each (~8 an entry), their sum (~4),
        the group's butterfly (~26 a shuffle and add, log2 G of them) and
        the cap's compare and select (~8); the next frame's u^H z runs
        beside it.  G lanes a bin (2 from 5 to 16 channels, up to 32
        above), E entries a lane."""
        G = 1 if N <= 4 else 2
        if N > 16:
            G = 1
            while G < 32 and 8 * G < N - 1:
                G *= 2
        E = -(-(N - 1) // G)
        return 32 + 8 * -(-E // 2) + 26 * int(math.log2(G))

    # U = 1 and 8 at 8 ch (the config-3 path and the JAX package's GSC
    # measurement); 2, 16, 17 (the first count whose bins take more lanes
    # as channels grow) and config 2's 64-ch circular 0.20 m array, each
    # timed at U = 1 and held to its twin at U = 8 (300 frames)
    ring = lambda N: ArrayGeometry.circular(N, 0.20 if N == 64 else 0.10).positions  # noqa: E731
    for U, POS, T_c in ((1, POS8, T_g), (8, POS8, T_g),
                        *((u_, np.asarray(ring(N_)), T_g if u_ == 1 else 300)
                          for N_ in (2, 16, 17, 64) for u_ in (1, 8))):
        Ng = len(POS)
        seed = 100 + U if Ng == 8 else (200 if U == 1 else 300) + Ng
        X, wq, Bm = gsc_case(U, seed, POS, T_c)
        kern = lambda: cgsc.gsc_nlms(X, wq, Bm, **gsc_args)          # noqa: E731
        plain = lambda: cgsc.gsc_nlms_plain(X, wq, Bm, **gsc_args)   # noqa: E731
        (Y, wa), (Y_p, wa_p) = kern(), plain()
        half = T_c // 2
        Y1, wa1 = cgsc.gsc_nlms(X[:, :, :half].contiguous(), wq, Bm, **gsc_args)
        Y2, wa2 = cgsc.gsc_nlms(X[:, :, half:].contiguous(), wq, Bm, **gsc_args, wa0=wa1)
        torch.cuda.synchronize()
        err_y, err_wa = rel_err(Y, Y_p), rel_err(wa, wa_p)
        scale = Y_p.abs().max()
        at = {t: float((Y[:, t - 1] - Y_p[:, t - 1]).abs().max() / scale)
              for t in (40, T_c // 2, T_c)}
        err_halves = max(rel_err(torch.cat([Y1, Y2], dim=1), Y), rel_err(wa2, wa))
        label = f"gsc U={U} N={Ng} T={T_c} K={K}"
        check(err_y <= TOL_ADAPTIVE and err_wa <= TOL_ADAPTIVE,
              f"{label}: kernel differs from its twin (Y {err_y:.3e}, wa {err_wa:.3e})")
        check(err_halves <= 1e-5, f"{label}: two halves threaded through wa0 differ from "
                                  f"one pass by {err_halves:.3e}")
        errs = (f"{label}: rel err Y {err_y:.2e} wa {err_wa:.2e} (bound {TOL_ADAPTIVE:.0e}); "
                f"Y error at frames {' / '.join(map(str, at))} "
                + " / ".join(f"{e:.2e}" for e in at.values())
                + f"; two halves through wa0 vs one pass {err_halves:.2e}")
        if T_c != T_g:
            print(errs)
            continue
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
        # X read once, wq and B read, Y and wa written; per step and bin
        # 8 N^2 + 28 (N - 1) + 4 operations (yc, z, y, |z|^2, update, norm, cap)
        b_ms, b_by = bound(8 * U * K * (Ng * T_g + Ng + Ng * (Ng - 1) + T_g + Ng - 1),
                           U * K * T_g * (8 * Ng * Ng + 28 * (Ng - 1) + 4))
        chain_ms = T_g * gsc_chain_cycles(Ng) / 1.98e9 * 1e3
        print(f"{errs}; kernel {ms:.4f} ms ({ms / T_g * 1e3:.3f} us per frame step)  plain "
              f"{plain_ms:.4f} ms  library n/a  bound {b_ms:.4f} ms ({b_by}); chain floor "
              f"estimated at {chain_ms:.4f} ms (~{gsc_chain_cycles(Ng)} cycles a frame at 1,980 "
              f"MHz, not measured)  [{smi}]")
        if U == 1 and Ng == 8:   # the config-3 path's shape
            record["gsc"] = dict(max_abs_err=float((Y - Y_p).abs().max()), rel_err=err_y, ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None)
    # frames fewer than one chunk, fewer than the ring's chunks in flight
    # (N = 8: 7 frames a chunk, 3 chunks ahead) and a single frame, at 8 and
    # 64 channels, U = 3
    short = []
    for Ng, T_s in ((8, 1), (8, 2), (8, 5), (8, 10), (64, 1), (64, 2), (64, 12)):
        X, wq, Bm = gsc_case(3, 400 + Ng + T_s, np.asarray(ring(Ng)), T_s)
        (Y, wa), (Y_p, wa_p) = (f(X, wq, Bm, **gsc_args) for f in (cgsc.gsc_nlms,
                                                                    cgsc.gsc_nlms_plain))
        err = max(rel_err(Y, Y_p), rel_err(wa, wa_p))
        check(err <= TOL_ADAPTIVE, f"gsc U=3 N={Ng} T={T_s}: rel err {err:.3e}")
        short.append(f"N={Ng} T={T_s} {err:.2e}")
    print(f"gsc at few frames, U=3, against the twin: {'; '.join(short)}")

    # the steering kernel against its twin (the composed steering vectors,
    # DS weights and apply): static delays and a moving source's trajectory
    for C in (8, 16):
        POSc = np.asarray(ArrayGeometry.circular(C, 0.10).positions)
        r = np.random.default_rng(200 + C)
        Xs = torch.view_as_complex(torch.as_tensor(
            r.standard_normal((C, T_g, K, 2)).astype(np.float32), device=dev)).contiguous()
        for traj in (False, True):
            path = ([np.array([0.5 + 1e-3 * t, 1.5, 0.3]) for t in range(T_g)] if traj
                    else [np.array([0.5, 1.5, 0.3])])
            taus = np.stack([design.steering_delays(POSc, p_, 343.0, SR) / SR for p_ in path])
            taus = torch.as_tensor(taus.astype(np.float32), device=dev)
            taus = taus if traj else taus[0].contiguous()
            label = f"{C} ch x {T_g} frames, {'per-frame' if traj else 'static'} delays"
            # X and the delays read, Y written; per (n, t, k) a phase product,
            # a sine and a cosine and a complex multiply-add (8 operations)
            res = compare("steering", label,
                          lambda: csteer.ds_beamform(Xs, taus, cfg.M, SR),
                          lambda: csteer.ds_beamform_plain(Xs, taus, cfg.M, SR),
                          8 * C * T_g * K + 4 * taus.numel() + 8 * T_g * K,
                          11 * C * T_g * K, tol=TOL_ADAPTIVE)
            if C == 8 and traj:   # the config-3 path's shape
                record["steering"] = res

    # the banded Viterbi kernel against its twin, bitwise (bp planes and the
    # final delta): the force-align shape (one utterance of 186 frames over
    # a 36-state chain, config 1's longest) and a batch of 8 x 1000 x 512
    for U, T_v, S_v in ((1, 186, 36), (8, 1000, 512)):
        r = np.random.default_rng(300 + S_v)
        llv = torch.as_tensor((r.standard_normal((U, T_v, S_v)) * 3).astype(np.float32),
                              device=dev)
        wsv = torch.as_tensor(np.log(r.uniform(0.3, 0.9, S_v)).astype(np.float32), device=dev)
        wav = torch.as_tensor(np.log(r.uniform(0.1, 0.7, S_v)).astype(np.float32), device=dev)
        wav[0] = NEG
        kern = lambda: cvit.banded_viterbi(llv, wsv, wav)          # noqa: E731
        plain = lambda: cvit.banded_viterbi_plain(llv, wsv, wav)   # noqa: E731
        (bp, dl), (bp_p, dl_p) = kern(), plain()
        torch.cuda.synchronize()
        same = torch.equal(bp, bp_p) and torch.equal(bits(dl), bits(dl_p))
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
        # ll read and bp (uint8) written per frame and state; the weights read
        # and delta written per state; 4 operations per frame and state
        b_ms, b_by = bound(U * (T_v * S_v * (4 + 1) + 4 * S_v * 4), 4 * U * T_v * S_v)
        # the lane kernel's dependent chain a frame, estimated from its
        # instructions: the ll load from shared memory (~30 cycles), the
        # shuffle (~25), then for the lane's first state an add, a compare,
        # a select and an add (~4 each); with more than one warp (S > 128)
        # also the boundary delta's store, the block barrier and its load
        # (~60): ~70 cycles a frame at S <= 128, ~130 above
        chain_ms = T_v * (70 if S_v <= 128 else 130) / 1.98e9 * 1e3
        print(f"viterbi U={U} T={T_v} S={S_v}: bp planes and delta bitwise equal to the twin "
              f"{same}; kernel {ms:.4f} ms ({ms / T_v * 1e3:.3f} us per frame)  plain "
              f"{plain_ms:.4f} ms  library n/a  bound {b_ms:.5f} ms ({b_by}); dependent-chain "
              f"floor estimated at {chain_ms:.4f} ms (~{70 if S_v <= 128 else 130} cycles a frame "
              f"at 1,980 MHz, not measured)  [{smi}]")
        check(same, f"viterbi U={U} T={T_v} S={S_v}: not bitwise equal to its twin")
        if U == 1:   # the force-align path's shape
            record["viterbi"] = dict(max_abs_err=float((dl - dl_p).abs().max()), rel_err=0.0,
                                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                     library_ms=None)

    # the kernels' variants for inputs beyond the main path's, against their
    # twins (no timing): the Viterbi lane kernel at one state, one warp's
    # edges (31, 33 states) and the most warps (1,024), a single frame, and
    # its stride loop (S > 1,024) with delta in device memory (S = 40,000);
    # the GSC front kernel with [wq, B] read from device memory (200
    # channels: 32 lanes a bin); the
    # select kernel with its sort buffer beyond a block's (kcap 9,000) and at
    # 300,000 candidates (kcap 64); the FFTs of the analysis and the fused
    # kernel a block a frame (M = 2048), in one shared buffer with their
    # stages held in registers and no twiddle table (M = 32,768), with their
    # buffers in device memory (M = 65,536) and at a prime M (127), and the
    # synthesis through device memory (M = 256 m = 8 r = 32: m r = 256 frames
    # a sample; M = 32,768: the held stages)
    for U, T_v, S_v in ((3, 70, 1), (2, 70, 31), (2, 70, 33), (2, 70, 1024), (2, 1, 36),
                        (2, 1, 512), (2, 30, 1025), (2, 50, 3000), (2, 40, 9000), (1, 20, 40000)):
        r = np.random.default_rng(S_v)
        llv = torch.as_tensor((r.standard_normal((U, T_v, S_v)) * 3).astype(np.float32),
                              device=dev)
        wsv, wav = (torch.as_tensor(np.log(r.uniform(lo, hi, S_v)).astype(np.float32), device=dev)
                    for lo, hi in ((0.3, 0.9), (0.1, 0.7)))
        wav[0] = NEG
        (bp, dl), (bp_p, dl_p) = (f(llv, wsv, wav) for f in (cvit.banded_viterbi,
                                                              cvit.banded_viterbi_plain))
        check(torch.equal(bp, bp_p) and torch.equal(bits(dl), bits(dl_p)),
              f"viterbi S={S_v}: not bitwise equal to its twin")
    # ll 1 to 3 floats past a 16-byte boundary inside a NaN-filled buffer: the
    # copies' ragged ends at the tensor's first and last floats
    for U, T_v, S_v in ((1, 186, 36), (3, 70, 1), (2, 1, 33)):
        r = np.random.default_rng(S_v + 1)
        n = U * T_v * S_v
        llh = torch.as_tensor((r.standard_normal((U, T_v, S_v)) * 3).astype(np.float32))
        wsv, wav = (torch.as_tensor(np.log(r.uniform(lo, hi, S_v)).astype(np.float32), device=dev)
                    for lo, hi in ((0.3, 0.9), (0.1, 0.7)))
        wav[0] = NEG
        bp_p, dl_p = cvit.banded_viterbi_plain(llh.to(dev), wsv, wav)
        for off in (1, 2, 3):
            buf = torch.full((n + 8,), float("nan"), device=dev)
            llv = buf[off:off + n].view(U, T_v, S_v)
            llv.copy_(llh)
            bp, dl = cvit.banded_viterbi(llv, wsv, wav)
            check(torch.equal(bp, bp_p) and torch.equal(bits(dl), bits(dl_p)),
                  f"viterbi S={S_v} ll at offset {off}: not bitwise equal to its twin")
    r = np.random.default_rng(7)
    POS200 = np.asarray(ArrayGeometry.circular(200, 0.30).positions)
    X = torch.view_as_complex(torch.as_tensor(
        r.standard_normal((2, 200, 60, 5, 2)).astype(np.float32), device=dev)).contiguous()
    v = bf.steering_vectors(torch.as_tensor(np.stack([
        design.steering_delays(POS200, p_, 343.0, SR) / SR
        for p_ in (np.array([0.5, 2.0, 0.0]), np.array([-1.0, 1.5, 0.3]))]).astype(np.float32),
        device=dev), cfg.M, SR)[:, :5]
    wq, Bm = bf.ds_weights(v).contiguous(), bf.blocking_matrix(v).contiguous()
    (Y, wa), (Y_p, wa_p) = (f(X, wq, Bm, **gsc_args) for f in (cgsc.gsc_nlms, cgsc.gsc_nlms_plain))
    err_g = max(rel_err(Y, Y_p), rel_err(wa, wa_p))
    check(err_g <= TOL_ADAPTIVE, f"gsc N=200: rel err {err_g:.3e}")
    # above 513 channels (the kernels with the weights in device memory)
    POS600 = np.asarray(ArrayGeometry.circular(600, 0.50).positions)
    X = torch.view_as_complex(torch.as_tensor(
        r.standard_normal((1, 600, 20, 3, 2)).astype(np.float32), device=dev)).contiguous()
    v = bf.steering_vectors(torch.as_tensor((design.steering_delays(
        POS600, np.array([0.5, 2.0, 0.0]), 343.0, SR) / SR)[None].astype(np.float32),
        device=dev), cfg.M, SR)[:, :3]
    wq, Bm = bf.ds_weights(v).contiguous(), bf.blocking_matrix(v).contiguous()
    (Y, wa), (Y_p, wa_p) = (f(X, wq, Bm, **gsc_args) for f in (cgsc.gsc_nlms, cgsc.gsc_nlms_plain))
    err_g600 = max(rel_err(Y, Y_p), rel_err(wa, wa_p))
    check(err_g600 <= TOL_ADAPTIVE, f"gsc N=600: rel err {err_g600:.3e}")
    for N, kcap in ((40000, 9000), (300000, 64)):
        args = select_case(N, kcap, 40.0, N + kcap)
        same = all(torch.equal(bits(o), bits(r_)) for o, r_ in zip(
            csel.recombine_topk(*args, kcap), csel.recombine_topk_plain(*args, kcap)))
        check(same, f"select N={N} kcap={kcap}: not bitwise equal to its twin")
    errs_x = {}
    for M, m, r_, C, secs in ((2048, 4, 2, 2, 1.0), (32768, 2, 2, 1, 8.0), (256, 8, 32, 2, 0.5)):
        c = FilterbankConfig(M=M, m=m, r=r_)
        h, g = (torch.as_tensor(rng.standard_normal(c.L).astype(np.float32) / 16, device=dev)
                for _ in range(2))
        xs = signal(C, secs)
        T = fb.num_frames(xs.shape[-1], c)
        ws = torch.view_as_complex(torch.as_tensor(
            rng.standard_normal((c.num_bins, C, 2)).astype(np.float32), device=dev)).contiguous()
        A = cfb.analysis_plain(xs, h, M, r_, T)
        errs_x[f"M={M} m={m} r={r_}"] = max(
            rel_err(cfb.analysis(xs, h, M, m, r_, T), A),
            rel_err(cfb.analysis_beamform(xs, h, ws, M, m, r_, T),
                    cfb.analysis_beamform_plain(xs, h, ws, M, r_, T)),
            rel_err(cfb.synthesis(A, g, M, m, r_, c.L - c.D, xs.shape[-1]),
                    cfb.synthesis_plain(A, g, M, r_, c.L - c.D, xs.shape[-1])))
    # the FFTs' other routes: buffers in device memory (M = 65,536) and a
    # prime M (one direct DFT stage), for the analysis and the synthesis; the
    # fused kernel there too, unstaged and over a staged bank of 2 (bitwise
    # equal), at 7, 63 and 64 channels
    for M, m, r_, C, secs in ((65536, 2, 2, 1, 8.0), (65536, 2, 2, 7, 2.0), (127, 2, 1, 2, 0.5),
                              (127, 2, 1, 7, 0.5), (127, 2, 1, 63, 0.5), (256, 4, 2, 7, 1.0),
                              (256, 4, 2, 63, 1.0)):
        c = FilterbankConfig(M=M, m=m, r=r_)
        h = torch.as_tensor(rng.standard_normal(c.L).astype(np.float32) / 16, device=dev)
        xs = signal(C, secs)
        T = fb.num_frames(xs.shape[-1], c)
        if C <= 2:
            A = cfb.analysis_plain(xs, h, M, r_, T)
            errs_x[f"analysis M={M} m={m} r={r_}"] = rel_err(cfb.analysis(xs, h, M, m, r_, T), A)
            # the synthesis's device route with its FFT buffers in device
            # memory (M = 65,536) and at the prime M
            errs_x[f"synthesis M={M} m={m} r={r_}"] = rel_err(
                cfb.synthesis(A, h, M, m, r_, c.L - c.D + 5, xs.shape[-1]),
                cfb.synthesis_plain(A, h, M, r_, c.L - c.D + 5, xs.shape[-1]))
        if C > 1:
            ws = torch.view_as_complex(torch.as_tensor(
                rng.standard_normal((c.num_bins, C, 2)).astype(np.float32), device=dev)).contiguous()
            yf = cfb.analysis_beamform(xs, h, ws, M, m, r_, T)
            bank2 = torch.stack([xs.flip(0), xs]).contiguous()
            same = torch.equal(cfb.analysis_beamform_staged(bank2, torch.tensor(
                1, dtype=torch.int32, device=dev), h, ws, M, m, r_, T), yf)
            check(same, f"fused M={M} C={C}: the staged kernel differs from the unstaged one")
            errs_x[f"analysis_beamform M={M} m={m} r={r_} {C} ch (staged bitwise)"] = rel_err(
                yf, cfb.analysis_beamform_plain(xs, h, ws, M, r_, T))
    print("kernel variants beyond the main path's shapes: viterbi S = 1 / 31 / 33 / 1,024 / "
          f"1,025 / 3,000 / 9,000 / 40,000, T = 1 and ll 1-3 floats past a 16-byte boundary "
          f"bitwise; gsc N = 200 / 600 rel err {err_g:.2e} / {err_g600:.2e}; "
          "select N = 40,000 kcap 9,000 and N = 300,000 kcap 64 bitwise; filterbank " + ", ".join(
              f"{k} {e:.2e}" for k, e in errs_x.items()) + f" (bound {TOL:.0e})")
    check(max(errs_x.values()) <= TOL, "filterbank kernels beyond the main path's configs")

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

    counters = (cfb, csel, cgsc, csteer, cvit)
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

    # ---- 5. config 3: the tracked adaptive front end -------------------------
    # An 8 s recording of an 8-mic 0.10 m circular array: a seeded white
    # source at SRC3 in free field (fractional delays as an rfft phase
    # shift) and independent sensor noise at 20 dB SNR on each mic.
    SRC3 = np.array([0.6, 1.5, 0.3])                 # tests/test_tracked_gsc_wer.py's
    PRIOR3 = SRC3 + np.array([0.5, -0.4, 0.2])       # the tracker starts here
    BL, HOP = 8000, 4000                             # 0.5 s GCC blocks at 50 % overlap
    S3 = int(8 * SR)
    rs3 = np.random.default_rng(3)
    taus_true = design.steering_delays(POS8, SRC3, 343.0, SR) / SR
    nfft3 = 1 << int(np.ceil(np.log2(S3 + SR * np.abs(taus_true).max() + 1)))
    f3 = np.fft.rfftfreq(nfft3, 1.0 / SR)
    x3 = np.fft.irfft(np.fft.rfft(rs3.standard_normal(S3), nfft3)[None]
                      * np.exp(-2j * np.pi * f3[None] * taus_true[:, None]), nfft3)[:, :S3]
    x3 += rs3.standard_normal(x3.shape) * np.sqrt(np.mean(x3 ** 2, axis=1, keepdims=True) / 100)
    x3 = x3.astype(np.float32)
    pairs3 = [(i, j) for i in range(N8) for j in range(i + 1, N8)]
    nb3 = (S3 - BL) // HOP + 1

    def tdoas3(x):
        """GCC-PHAT TDOAs (blocks, 28 pairs) of x (N, S), seconds."""
        return torch.stack([tde.gcc_phat_pairs(x[:, b * HOP:b * HOP + BL], pairs3, SR,
                                               max_tau=0.21 / 343.0, interp=16)
                            for b in range(nb3)])

    def track3(td):
        """The IEKF from the displaced prior: 40 epochs over the per-pair
        medians, then the blocks in order → positions (40 + blocks, 3)."""
        dev_ = td.device
        PI, PJ = (torch.tensor([p_[k] for p_ in pairs3], device=dev_) for k in (0, 1))
        seq = torch.cat([torch.quantile(td, 0.5, dim=0).expand(40, -1), td])
        return trk.track(seq, torch.as_tensor(PRIOR3.astype(np.float32), device=dev_),
                         0.09 * torch.eye(3, device=dev_),
                         torch.as_tensor(POS8.astype(np.float32), device=dev_), PI, PJ,
                         q=1e-6, r=1e-8)

    def config3(x, stage_s=None):
        """One config-3 request: (N, S) → TDOAs, track, delays, both
        beamformers' subbands and waveforms, GSC features.  With a dict
        `stage_s`, the host-clock seconds of its three stages (the card
        synchronised after each) are added to it."""
        marks = [time.perf_counter()]

        def mark():
            if stage_s is not None:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

        td = tdoas3(x)
        mark()
        est = track3(td)
        mark()
        POS = torch.as_tensor(POS8.astype(np.float32), device=x.device)
        A = fb.analysis(x, cfg)
        taus = trk.steering_delays_from_position(est[39], POS)
        block = np.clip((np.arange(A.shape[1]) * cfg.D - BL // 2) // HOP, 0, nb3 - 1)
        taus_t = torch.stack([trk.steering_delays_from_position(p_, POS)
                              for p_ in est[-nb3:]])[torch.as_tensor(block, device=x.device)]
        out = dict(td=td, est=est, A=A, taus=taus, taus_t=taus_t,
                   **beamform3(A, taus, taus_t.contiguous(), x.shape[-1]))
        mark()
        if stage_s is not None:
            for name, a, b in zip(("TDOAs", "tracker", "analysis, GSC, DS, synthesis, MFCC"),
                                  marks, marks[1:]):
                stage_s[name] = stage_s.get(name, 0.0) + (b - a)
        return out

    def beamform3(A, taus, taus_t, S):
        """MVDR-quiescent GSC and tracked DS of A (N, T, K), synthesis, GSC features."""
        v = bf.steering_vectors(taus, cfg.M, SR)
        Gamma = bf.diffuse_coherence(POS8, cfg.M, SR, 343.0, A.device)
        w = bf.mvdr_weights(v, Gamma, 1e-2)
        Y_g, _ = bf.gsc_nlms(A, w, bf.blocking_matrix(v), 0.05, 1e-6, 10.0)
        Y_d = bf.ds_beamform(A, taus_t, cfg.M, SR)
        return dict(Y_g=Y_g, Y_d=Y_d, y_g=fb.synthesis(Y_g, cfg, S), y_d=fb.synthesis(Y_d, cfg, S),
                    feats=ft.cmn(ft.mfcc_from_subbands(Y_g, cfg.M, SR)))

    x3_t = torch.as_tensor(x3, device=dev)
    out3 = counted("config 3 (TDOA -> IEKF -> tracked GSC + tracked DS -> synthesis -> MFCC)",
                   lambda: config3(x3_t),
                   {"analysis": 1, "synthesis": 2, "gsc": 1, "steering": 1})
    steer_err = float(np.mean(np.abs(out3["taus"].cpu().numpy() - taus_true)))
    traj_err = float(np.mean(np.abs(out3["taus_t"].cpu().numpy() - taus_true[None])))
    pos_err = float(np.linalg.norm(out3["est"][39].cpu().numpy() - SRC3))
    T3 = out3["A"].shape[1]
    print(f"config 3: {nb3} blocks x 28 pair TDOAs, tracked position {pos_err:.3f} m from the "
          f"source (prior 0.678 m off); mean steering error {steer_err * 1e6:.2f} us (gate < 30 "
          f"us), along the per-block trajectory {traj_err * 1e6:.2f} us; {T3} frames")
    check(steer_err < 30e-6, "config 3: the tracker's steering error")
    check(all(bool(torch.isfinite(out3[k]).all()) for k in ("Y_g", "Y_d", "y_g", "y_d", "feats"))
          and out3["y_g"].shape == (S3,) and out3["Y_d"].shape == (T3, K),
          "config 3: finite outputs of the expected shapes")
    ref3 = beamform3(fb.analysis(torch.as_tensor(x3), cfg), out3["taus"].cpu(),
                     out3["taus_t"].cpu().contiguous(), S3)
    errs3 = {k: rel_err(out3[k].cpu(), ref3[k]) for k in ("Y_g", "Y_d", "y_g", "y_d", "feats")}
    print("config 3 card vs CPU plain path fed the same delays: "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs3.items()) + " (bound 1e-4)")
    check(max(errs3.values()) <= 1e-4, "config 3: the card agrees with the CPU plain path")

    def host_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    A3, td3 = out3["A"], out3["td"]
    v3 = bf.steering_vectors(out3["taus"], cfg.M, SR)
    w3 = bf.mvdr_weights(v3, bf.diffuse_coherence(POS8, cfg.M, SR, 343.0, dev), 1e-2)
    B3 = bf.blocking_matrix(v3)
    reps3, stage_s = 3, {}
    req3_ms = host_ms(lambda: config3(x3_t, stage_s), reps=reps3)
    stage_s = {k: v / (reps3 + 1) * 1e3 for k, v in stage_s.items()}   # warm-up call included
    kern3 = {"GSC kernel": cuda_ms(lambda: bf.gsc_nlms(A3, w3, B3, 0.05, 1e-6, 10.0), iters=10),
             "DS kernel": cuda_ms(lambda: bf.ds_beamform(A3, out3["taus_t"], cfg.M, SR), iters=10),
             "tracker on the host CPU (same TDOAs)": host_ms(lambda: track3(td3.cpu()))}
    print(f"config 3 request 8 ch x 8 s: {req3_ms:.1f} ms on the host clock = "
          f"{8.0 / (req3_ms / 1e3):.1f} audio-s/s [{smi}]; its stages (host clock, ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in stage_s.items())
          + "; the kernels on the card's clock and the tracker on the host (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in kern3.items()))

    # DsrPipeline(kind="gsc"): the Zelinski post-filter (process, and
    # process_streaming over 0.5 s blocks, examples/streaming_beamformer.py's
    # path) and WPE dereverberation, card against the CPU plain path
    def gsc_pipe(device=None, **kw):
        return DsrPipeline(fb=cfg, geometry=ArrayGeometry.circular(8, 0.10),
                           beamformer=BeamformerConfig(kind="gsc"), device=device, **kw)

    xg = requests[0]
    Sg = xg.shape[-1]
    pipe_z, cpu_z = gsc_pipe(postfilter="zelinski"), gsc_pipe("cpu", postfilter="zelinski")
    y_z, f_z = counted("process gsc + zelinski", lambda: pipe_z.process(xg, SOURCE),
                       {"analysis": 1, "synthesis": 1})
    y_zc, f_zc = cpu_z.process(xg, SOURCE)
    blocks = [xg[:, i:i + 8000] for i in range(0, Sg, 8000)]
    ys_z = counted("process_streaming gsc + zelinski",
                   lambda: torch.cat(list(pipe_z.process_streaming(blocks, SOURCE))),
                   {"analysis": len(blocks) + 1, "synthesis": len(blocks) + 1})
    ys_zc = torch.cat(list(cpu_z.process_streaming(blocks, SOURCE)))
    pipe_w, cpu_w = gsc_pipe(dereverb=True), gsc_pipe("cpu", dereverb=True)
    y_w, f_w = counted("process gsc + dereverb", lambda: pipe_w.process(xg, SOURCE),
                       {"analysis": 1, "synthesis": 1})
    # WPE's normal equations on these subbands have condition numbers ~1e9
    # (white noise through the oversampled filterbank, and the pad frames),
    # so float32 WPE scatters by O(1) on any two libraries (the CPU tests
    # hold it to float64 and to the JAX package on well-conditioned data):
    # the card's dereverbed subbands are checked finite, then fed to both
    # the card's and the CPU's beamforming and synthesis; and WPE itself is
    # compared on well-conditioned AR subbands (8 ch x 1000 frames x 129).
    A_w = der.wpe(fb.analysis(torch.as_tensor(xg, device=dev), cfg))
    y_wd = fb.synthesis(pipe_w.beamform_subbands(A_w, SOURCE)[0], cfg, Sg)
    y_wc = fb.synthesis(cpu_w.beamform_subbands(A_w.cpu(), SOURCE)[0], cfg, Sg)
    ra = np.random.default_rng(9)
    Yar = ra.standard_normal((8, 1000, K)) + 1j * ra.standard_normal((8, 1000, K))
    for t in range(3, 1000):
        Yar[:, t] += 0.54 * Yar[:, t - 3]
    Yar = torch.as_tensor(Yar.astype(np.complex64))
    errs_p = {"process y": rel_err(y_z.cpu(), y_zc), "process feats": rel_err(f_z.cpu(), f_zc),
              "process_streaming y": rel_err(ys_z.cpu(), ys_zc),
              "dereverb: beamform + synthesis of the card's WPE output": rel_err(y_wd.cpu(), y_wc),
              "WPE on AR subbands": rel_err(der.wpe(Yar.to(dev)).cpu(), der.wpe(Yar))}
    print("DsrPipeline(kind='gsc') card vs CPU plain path: "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs_p.items()) + " (bound 1e-4)")
    check(bool(torch.isfinite(y_w).all() and torch.isfinite(f_w).all() and torch.isfinite(A_w).all()),
          "dereverb: finite outputs")
    check(torch.equal(y_w, y_wd), "dereverb: process is WPE, then beamform and synthesis")
    check(max(errs_p.values()) <= 1e-4, "DsrPipeline(kind='gsc') agrees with the CPU plain path")
    times_p = {"process gsc + zelinski": host_ms(lambda: pipe_z.process(xg, SOURCE)),
               "process_streaming gsc + zelinski (8 blocks)": host_ms(
                   lambda: list(pipe_z.process_streaming(blocks, SOURCE))),
               "process gsc + dereverb": host_ms(lambda: pipe_w.process(xg, SOURCE))}
    print(f"DsrPipeline(kind='gsc') 8 ch x 4 s on the host clock [{smi}]: "
          + ", ".join(f"{k} {v:.1f} ms ({4.0 / (v / 1e3):.1f} audio-s/s)"
                      for k, v in times_p.items()))

    # ---- 6. the decode ------------------------------------------------------
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
    sf, scf, ts, ta, _, _, _ = tk.token_pass(
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

    # the streaming recogniser over a GSC pipeline: its weights adapt across
    # chunks, so its frames are held to the CPU plain path's streamed frames
    pipe_sg = DsrPipeline(fb=cfg, geometry=ArrayGeometry.circular(8, 0.10),
                          beamformer=BeamformerConfig(kind="gsc"))
    cpu_sg = DsrPipeline(fb=cfg, geometry=ArrayGeometry.circular(8, 0.10),
                         beamformer=BeamformerConfig(kind="gsc"), device="cpu")
    frames_g = torch.cat(list(pipe_sg.process_streaming_subbands(chunks, SOURCE)))
    frames_c = torch.cat(list(cpu_sg.process_streaming_subbands(chunks, SOURCE)))
    e_frames = rel_err(frames_g.cpu(), frames_c)
    rec_g = StreamingRecognizer(pipe_sg, lambda f: gmm.loglik(am_s, f), tg300, SOURCE,
                                cep_mean=cep_mean)
    words_g, score_g = counted("streaming over GSC", lambda: rec_g.run(chunks),
                               {"analysis": len(chunks), "select": frames_g.shape[0]})
    print(f"streaming recogniser over GSC ({len(chunks)} chunks, {frames_g.shape[0]} frames): "
          f"subband frames card vs CPU plain path rel err {e_frames:.2e} (bound 1e-4); "
          f"{len(words_g)} words, score {score_g:.3f}")
    check(e_frames <= 1e-4, "GSC streamed frames: the card agrees with the CPU plain path")
    check(len(words_g) > 0 and math.isfinite(score_g), "the GSC streaming recogniser gives words")

    # ---- 6P. P: config 4, the graph-sharded decode and the collectives ------
    phase_parallel(types.SimpleNamespace(dev=dev, smi=smi, counted=counted, bits=bits), task, tg,
                   ll, kcap=kcap, beam=beam)

    # ---- 7. BASELINE config 1 ------------------------------------------------
    # The synthetic corpus (the port's copy of golden/corpus.py), MFCC + CMN
    # on the card, whole-word GMM-HMMs trained on the card from a flat start
    # (4 Viterbi-EM iterations over 60 utterances, as
    # tests/test_asr_smallvocab.py trains them), forced alignment through the
    # banded kernel, the word-loop decode, the 8-ch delay-and-sum path, and
    # the phone task's bigram HCLG decode.
    def c1_feats(x):
        return ft.cmn(ft.mfcc(torch.as_tensor(np.asarray(x, np.float32), device=dev),
                              SR)).cpu().numpy()

    def host_copy(p_):
        return gmm.GmmParams(p_.means.cpu(), p_.variances.cpu(), p_.logweights.cpu())

    def timed(fn):
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        out_ = fn()
        torch.cuda.synchronize()
        return out_, time.perf_counter() - t0_

    def wer_of(refs, hyps):
        sc = WerScorer()
        for ref, hyp in zip(refs, hyps):
            sc.add(ref, hyp)
        return sc

    train1 = corpus.make_corpus(60, seed=0)
    feats1 = [c1_feats(x) for _, x in train1]
    words1 = [ws for ws, _ in train1]
    task1 = smallvocab.SmallVocabTask(corpus.VOCAB)
    params1, t_train1 = timed(lambda: counted(
        "config 1 train (60 utterances, 4 Viterbi-EM iterations)",
        lambda: trainer.train(task1, feats1, words1, num_comp=2, iters=4), {}))
    params1_cpu = trainer.train(task1, feats1, words1, num_comp=2, iters=4, device="cpu")
    # the card's and the CPU's training on the same features: float32 sums in
    # another order (GMM matmul, einsum accumulators) over 4 iterations whose
    # alignments are equal; measured on the CPU against the JAX package the
    # trainers agree to ~4e-5 relative (tests/test_torch_trainer.py, 5e-4)
    e_train = max_rel(params1, params1_cpu)
    print(f"config 1 train: 60 utterances ({sum(len(f) for f in feats1)} frames, longest "
          f"{max(len(f) for f in feats1)}; chains of up to "
          f"{max(len(task1.align_graph(w)[0]) for w in words1)} states), 4 iterations: "
          f"{t_train1:.3f} s on the host clock [{smi}]; card vs CPU plain path trained "
          f"means, variances and log-weights max |a - b| / (|b| + 1) {e_train:.2e} "
          "(bound 5e-4)")
    check(e_train <= 5e-4, "config 1: the card's training agrees with the CPU plain path")

    aligns, t_align = timed(lambda: counted(
        "config 1 force-align (60 utterances)",
        lambda: [apath.force_align(task1, params1, f, w) for f, w in zip(feats1, words1)],
        {"viterbi": len(feats1)}))
    p1_host = host_copy(params1)
    ties = 0
    for f, w, a in zip(feats1, words1, aligns):
        ref = apath.force_align(task1, p1_host, f, w)     # the CPU: dense viterbi
        check(len(a.segments) == len(ref.segments) == len(task1.align_graph(w)[0])
              and np.isfinite(a.score), "config 1: an alignment visits every chain state")
        if a.segments != ref.segments:
            # an exact-score tie: on the card's own log-likelihoods, summed
            # as the kernel sums them, the CPU's path scores exactly what the
            # card's does; anything else fails
            check(exact_tie(params1, task1, f, w, a.segments, ref.segments),
                  "config 1: the card's alignment differs from the CPU's off an exact tie")
            ties += 1
        check(abs(a.score - ref.score) <= 1e-3 * abs(ref.score),
              "config 1: alignment scores, card vs CPU")
    print(f"config 1 force-align: 60 utterances through the banded kernel in {t_align:.3f} s; "
          f"segments equal to the CPU's dense alignment in {len(aligns) - ties} of 60, "
          f"{ties} at an exact-score tie (banded keeps self, dense advances)")

    eval1 = corpus.make_corpus(10, seed=100)
    feats_e = [c1_feats(x) for _, x in eval1]
    audio_e = sum(len(x) for _, x in eval1) / SR
    hyps_e, t_dec = timed(lambda: counted("config 1 clean decode (10 utterances)",
                                          lambda: trainer.decode(task1, params1, feats_e), {}))
    wer_e = wer_of([ws for ws, _ in eval1], hyps_e)
    hyps_e_cpu = trainer.decode(task1, params1_cpu, feats_e)
    print(f"config 1 clean decode, 10 utterances: {wer_e} (gate 0.05); {t_dec:.3f} s = "
          f"{audio_e / t_dec:.1f} audio-s/s on the host clock [{smi}]; words equal to the CPU "
          f"plain path's (its own training) {hyps_e == hyps_e_cpu}")
    check(wer_e.wer <= 0.05, "config 1: clean decode WER")
    check(hyps_e == hyps_e_cpu, "config 1: clean decode words, card vs CPU")

    # 8-ch delay-and-sum: a linear 4 cm array, the source at (0.4, 1.8, 0.2)
    # m in free field (fractional delays as an rfft phase shift) and white
    # sensor noise at 10 dB SNR, as tests/test_asr_smallvocab.py records it
    POS1 = np.asarray(ArrayGeometry.linear(8, 0.04).positions)
    SRC1 = np.array([0.4, 1.8, 0.2])
    taus1 = design.steering_delays(POS1, SRC1, 343.0, SR)
    w1 = bf.ds_weights(bf.steering_vectors(
        torch.as_tensor((taus1 / SR).astype(np.float32), device=dev), cfg.M, SR))
    rs1 = np.random.default_rng(7)

    def record8(x):
        nfft = 1 << int(np.ceil(np.log2(2 * len(x))))
        f_ = np.arange(nfft // 2 + 1) / nfft
        xm = np.fft.irfft(np.fft.rfft(x, nfft)[None] * np.exp(-2j * np.pi * f_[None]
                                                             * taus1[:, None]), nfft)[:, :len(x)]
        xm += rs1.standard_normal(xm.shape) * np.sqrt(np.mean(x ** 2) / 10.0)
        return xm.astype(np.float32)

    eval_bf = corpus.make_corpus(6, seed=200)
    x_bf = [record8(x) for _, x in eval_bf]
    audio_bf = sum(x.shape[-1] for x in x_bf) / SR

    def beamformed():
        feats_b, aligns_b = [], []
        for x, (ws, _) in zip(x_bf, eval_bf):
            xt = torch.as_tensor(x, device=dev)
            y = fb.synthesis(bf.apply_weights(fb.analysis(xt, cfg), w1), cfg, xt.shape[-1])
            feats_b.append(ft.cmn(ft.mfcc(y, SR)).cpu().numpy())
            aligns_b.append(apath.force_align(task1, params1, feats_b[-1], ws))
        return feats_b, aligns_b, trainer.decode(task1, params1, feats_b)

    (feats_b, aligns_b, hyps_b), t_bf = timed(lambda: counted(
        "config 1 beamformed (analysis -> DS -> synthesis -> MFCC -> align, decode)",
        beamformed, {"analysis": len(x_bf), "synthesis": len(x_bf), "viterbi": len(x_bf)}))
    wer_b = wer_of([ws for ws, _ in eval_bf], hyps_b)
    hyps_b_cpu = trainer.decode(task1, params1_cpu, feats_b)
    print(f"config 1 beamformed, 6 utterances: {wer_b} (gate 0.15); the path took {t_bf:.3f} "
          f"s = {audio_bf / t_bf:.1f} audio-s/s on the host clock [{smi}]; words equal to "
          f"the CPU plain path's on the same features {hyps_b == hyps_b_cpu}")
    check(wer_b.wer <= 0.15, "config 1: beamformed decode WER")
    check(hyps_b == hyps_b_cpu, "config 1: beamformed decode words, card vs CPU")
    check(all(np.isfinite(a.score) and a.segments[-1][2] == len(f)
              for a, f in zip(aligns_b, feats_b)), "config 1: beamformed alignments")

    # the phone task: the same training, the bigram HCLG (the port's WFST
    # core) and the dense WFST decode over the clean and beamformed audio
    ptask = phone_task.PhoneTask(corpus.VOCAB, states_per_phone=2)
    pparams, t_ptrain = timed(lambda: trainer.train(ptask, feats1, words1, num_comp=2, iters=4))
    P1 = len(ptask.phones) - 1
    G1 = lm.arpa_to_fst(lm.train_arpa_bigram(words1, ptask.vocab), ptask.words)
    L1, ndis1 = hclg.build_lexicon_fst(ptask.lexicon, ptask.phones, ptask.words, sil_phone="sil")
    pg1 = pack(hclg.compose_hclg(hclg.build_hmm_fst(P1, ndis1, states_per_phone=ptask.spp), L1,
                                 G1, P1, ndis1))
    graph1 = wd.to_device(pg1)

    def phone_decode(g, p_, feats_list, device):
        return [wd.words_from_olabels(wd.decode(g, gmm.loglik(p_, torch.as_tensor(
            f, device=device)))[0], ptask.words) for f in feats_list]

    hyps_p, t_wfst = timed(lambda: counted(
        "config 1 phone task, bigram HCLG decode (clean + beamformed)",
        lambda: phone_decode(graph1, pparams, feats_e + feats_b, dev), {}))
    hyps_p_cpu = phone_decode(wd.to_device(pg1, device="cpu"), host_copy(pparams),
                              feats_e + feats_b, "cpu")
    wer_pc = wer_of([ws for ws, _ in eval1], hyps_p[:10])
    wer_pb = wer_of([ws for ws, _ in eval_bf], hyps_p[10:])
    print(f"config 1 phone task: trained in {t_ptrain:.3f} s; HCLG {pg1.num_states} states, "
          f"{pg1.num_arcs} arcs; decode clean {wer_pc}, beamformed {wer_pb}; {t_wfst:.3f} s = "
          f"{(audio_e + audio_bf) / t_wfst:.1f} audio-s/s on the host clock [{smi}]; words "
          f"equal to the CPU plain path's (same model) {hyps_p == hyps_p_cpu}")
    check(hyps_p == hyps_p_cpu, "config 1 phone task: decode words, card vs CPU")
    check(wer_pc.wer <= 0.5, "config 1 phone task: clean decode recognises the corpus")

    # ---- 8. L: lattices on the V = 2000 graph -------------------------------
    # 4 in-domain sentences of at least 11 words (about 500 frames each) from
    # the bench task's own text generator, rendered for its synthetic AM
    cfg2k = lvcsr.LvcsrConfig()
    rng2k = np.random.default_rng(cfg2k.seed)
    lex2k = lvcsr.make_lexicon(cfg2k.vocab_size, rng2k)
    text2k = lvcsr.make_text(sorted(lex2k), cfg2k.n_tokens, cfg2k.branching, rng2k)
    sents = [s_ for s_ in text2k if len(s_) >= 11][:4]
    am2k = lvcsr.synthetic_am(task).to(dev)
    rs8 = np.random.default_rng(8)
    lls = [gmm.loglik(am2k, torch.as_tensor(lvcsr.synthesize_utterance(task, s_, rs8), device=dev))
           for s_ in sents]
    frames_l = [int(l_.shape[0]) for l_ in lls]
    tk.decode_with_tokens(tg, lls[0][:20], kcap=256, beam=40.0, nlat=4)    # warm-up
    lat_outs, t_ldec = timed(lambda: counted(
        "L: lattice decode (V=2000, 4 sentences, kcap 256, beam 40, nlat 4)",
        lambda: [tk.decode_with_tokens(tg, l_, kcap=256, beam=40.0, nlat=4) for l_ in lls],
        {"select_lattice": sum(frames_l)}))
    host_s = dict.fromkeys(("from_topk", "forward_backward", "one_best", "oracle", "consensus"),
                           0.0)
    errs_l = []
    for s_, out in zip(sents, lat_outs):
        olabs, _, ts_, ta_, tsc_, aa, asc = out
        t0 = time.perf_counter()
        lt = lattice.from_topk(ts_, ta_, tsc_, tg, aa, asc)
        t1 = time.perf_counter()
        _, _, logZ, post = lt.forward_backward()
        t2 = time.perf_counter()
        best, _ = lt.one_best()
        t3 = time.perf_counter()
        ref_ids = [task.words[w] for w in s_]
        oracle = lt.oracle_errors(ref_ids)
        t4 = time.perf_counter()
        cons = lattice.consensus(lt, min_post=0.01, max_links=4096)
        t5 = time.perf_counter()
        for k_, a_, b_ in zip(host_s, (t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
            host_s[k_] += b_ - a_
        sums = post.sum(axis=(1, 2))
        words_dec = [int(w) for w in olabs if w]
        sub, dele, ins, _ = edit_distance(ref_ids, cons)
        errs_l.append((oracle, sub + dele + ins, sum(edit_distance(ref_ids, words_dec)[:3])))
        check(bool(np.isfinite(logZ)) and float(np.abs(sums - 1.0).max()) <= 1e-3,
              f"L: link posteriors sum to 1 per frame (max off {np.abs(sums - 1).max():.2e})")
        check(best == words_dec, "L: the lattice's 1-best equals the decode's words")
        check(oracle <= errs_l[-1][2], "L: the oracle is no worse than the 1-best")
    print(f"L: lattice decode of {len(sents)} sentences ({frames_l} frames, "
          f"{[len(s_) for s_ in sents]} words): {t_ldec:.3f} s on the host clock = "
          f"{sum(frames_l) / 125.0 / t_ldec:.1f} audio-s/s, {t_ldec / sum(frames_l) * 1e3:.3f} ms "
          f"per frame; select lattice kernel {record['select_lattice']['ms']:.4f} ms at U=8 (U=1 "
          f"here); errors per sentence (oracle, consensus, 1-best) {errs_l}; host seconds for all "
          f"4: " + ", ".join(f"{k_} {v_:.3f}" for k_, v_ in host_s.items()) + f"  [{smi}]")
    # one sentence's tables, card against the CPU plain path, same log-likelihoods
    out_cpu = tk.decode_with_tokens(cpu_graphs["dense"], lls[0].cpu(), kcap=256, beam=40.0,
                                    nlat=4)
    same_l = all(torch.equal(bits(a_.cpu()), bits(b_)) for a_, b_ in zip(lat_outs[0][2:],
                                                                          out_cpu[2:]))
    print(f"L: sentence 0 token and alt tables card vs CPU plain path bitwise equal {same_l}; "
          f"words equal {torch.equal(lat_outs[0][0], out_cpu[0])}")
    check(same_l and torch.equal(lat_outs[0][0], out_cpu[0]),
          "L: the card's lattice tables differ from the CPU plain path's")

    # ---- 9. MM: lattice MMI at config 1's width -------------------------------
    # the phone task (full vocabulary) trained in phase 7, its bigram HCLG
    # (tools/exp_mmi.py's graph), the 60 training utterances
    S1 = pg1.num_states
    (p_mmi, hist), t_ebw = timed(lambda: counted(
        "MM: ebw_train (60 utterances, 4 iterations)",
        lambda: mmi.ebw_train(ptask, pparams, graph1, feats1, words1, iters=4),
        {"viterbi": 5 * len(feats1)}))
    hist = np.asarray(hist)
    check(bool(np.isfinite(hist).all() and (np.diff(hist) > 0).all()),
          f"MM: EBW criterion not strictly increasing: {hist}")
    p5, h5 = mmi.ebw_train(ptask, pparams, graph1, feats1[:5], words1[:5], iters=2)
    p5c, h5c = mmi.ebw_train(ptask, host_copy(pparams), wd.to_device(pg1, device="cpu"),
                             feats1[:5], words1[:5], iters=2)
    e_h = float(np.max(np.abs(np.asarray(h5) - h5c) / np.abs(h5c)))
    e_p = max_rel(p5, p5c)
    # where the time goes: one pass's alignments and full-graph denominators
    # (one padded batch of the 60 utterances, as ebw_train runs them)
    _, t_al = timed(lambda: [apath.force_align(ptask, pparams, f, w)
                             for f, w in zip(feats1, words1)])
    fpad1 = torch.nn.utils.rnn.pad_sequence(
        [torch.as_tensor(f, device=dev) for f in feats1], batch_first=True)
    _, t_den = timed(lambda: mmi.denominator_gamma(
        graph1, gmm.loglik(pparams, fpad1), return_total=True, lengths=[len(f) for f in feats1]))
    print(f"MM: ebw_train 60 utterances ({sum(len(f) for f in feats1)} frames), HCLG {S1} "
          f"states / {pg1.num_arcs} arcs, 4 iterations: {t_ebw:.3f} s on the host clock "
          f"[{smi}]; criterion {[round(float(h), 2) for h in hist]}; per pass: force_align "
          f"{t_al:.3f} s, full-graph denominators {t_den:.3f} s; 5 utterances x 2 iterations "
          f"card vs CPU plain path: criterion rel err {e_h:.2e}, parameters max |a - b| / "
          f"(|b| + 1) {e_p:.2e} (bound 5e-4)")
    check(e_h <= 5e-4 and e_p <= 5e-4, "MM: the card's EBW agrees with the CPU plain path")
    tg1 = tk.build_token_graph(pg1, device=dev)
    ll_1, ll_4 = (gmm.loglik(pparams, torch.as_tensor(feats1[i], device=dev)) for i in (1, 4))

    def lattice_denominators():
        return (mmi.denominator_gamma_lattice(tg1, ll_1, kcap=S1, beam=1e9,
                                              nlat=min(S1 * tg1.a_max, 512)),
                mmi.denominator_gamma_lattice(tg1, ll_4, kcap=24, beam=30.0, nlat=6))

    (g_ex, g_pr), t_lden = timed(lambda: counted(
        "MM: lattice denominators (exhaustive, pruned)", lattice_denominators,
        {"select_lattice": ll_1.shape[0] + ll_4.shape[0]}))
    g_d1, g_d4 = (mmi.denominator_gamma(graph1, l_).cpu().numpy() for l_ in (ll_1, ll_4))
    d_ex, d_pr = float(np.abs(g_ex - g_d1).max()), float(np.abs(g_pr - g_d4).mean())
    print(f"MM: lattice denominator vs full graph: exhaustive (kcap {S1}, nlat "
          f"{min(S1 * tg1.a_max, 512)}) max |diff| {d_ex:.2e} (gate 2e-3), pruned (kcap 24, beam "
          f"30, nlat 6) mean |diff| {d_pr:.2e} (gate 0.02); {t_lden:.3f} s for both")
    check(float(np.abs(g_ex.sum(axis=1) - 1).max()) <= 1e-3 and d_ex < 2e-3,
          "MM: exhaustive lattice denominator")
    check(float(np.abs(g_pr.sum(axis=1) - 1).max()) <= 1e-2 and d_pr < 0.02,
          "MM: pruned lattice denominator")

    # ---- 10. SB: the staged buffer bank ---------------------------------------
    # bench.py's bank: 8 buffers of 64 ch x 8 s, staged once; the MVDR weights
    # of phase 2; the buffer index from the host and from device memory
    NBUF = 8
    xp_bank = fb.stage_for_beamform(
        np.random.default_rng(10).standard_normal((NBUF, 64, S64)).astype(np.float32))
    idx_dev = torch.arange(NBUF, dtype=torch.int32, device=dev)
    for i in range(NBUF):
        ref = fb.analysis_beamform(xp_bank[i], w64, cfg, hf_t)
        check(torch.equal(fb.analysis_beamform_staged(xp_bank, i, w64, cfg, S64, hf_t), ref)
              and torch.equal(fb.analysis_beamform_staged(xp_bank, idx_dev[i], w64, cfg, S64,
                                                          hf_t), ref),
              f"SB: buffer {i} differs from the unstaged fused kernel")
    bad = fb.analysis_beamform_staged(xp_bank, torch.tensor(NBUF, dtype=torch.int32, device=dev),
                                      w64, cfg, S64, hf_t)
    check(bool(torch.isnan(bad).all()), "SB: an out-of-range device index gives NaN")

    def serve_bank(n):
        """n requests over the bank: fused analysis + beamform of buffer
        i % 8 (index read on the card), then the synthesis."""
        return [fb.synthesis(fb.analysis_beamform_staged(xp_bank, idx_dev[i % NBUF], w64, cfg,
                                                         S64, hf_t), cfg, S64, gf_t, delay)
                for i in range(n)]

    ys_bank = counted("SB: serving loop over the staged bank (16 requests)",
                      lambda: serve_bank(2 * NBUF),
                      {"analysis_beamform_staged": 2 * NBUF, "synthesis": 2 * NBUF})
    check(all(bool(torch.isfinite(y_).all()) for y_ in ys_bank), "SB: finite outputs")
    bank_ms = cuda_ms(lambda: serve_bank(NBUF), iters=3) / NBUF
    fused_ms = cuda_ms(lambda: [fb.analysis_beamform_staged(xp_bank, idx_dev[i], w64, cfg, S64,
                                                            hf_t) for i in range(NBUF)],
                       iters=3) / NBUF
    print(f"SB: bank of {NBUF} x 64 ch x 8 s ({xp_bank.numel() * 4 / 1e6:.0f} MB) staged once; "
          f"every buffer by int and by device index bitwise equal to the unstaged kernel; "
          f"serving loop (no host readback) {bank_ms:.3f} ms per request = "
          f"{8.0 / (bank_ms / 1e3):.1f} audio-s/s, the fused kernel alone {fused_ms:.3f} ms = "
          f"{8.0 / (fused_ms / 1e3):.1f} audio-s/s [{smi}]")
    record["analysis_beamform_staged"] = compare(
        "analysis_beamform_staged", "bank 8 x 64 ch x 8 s, device index",
        lambda: fb.analysis_beamform_staged(xp_bank, idx_dev[3], w64, cfg, S64, hf_t),
        lambda: cfb.analysis_beamform_plain(xp_bank[3], hf_t, w64, cfg.M, cfg.r, T64),
        4 * (64 * S64 + cfg.L) + 8 * K * 64 + 8 * T64 * K,
        64 * T64 * (2 * cfg.L + rfft_flops(cfg.M) + 8 * K))

    # ---- 11. FE: the rest of the front end (slice 8) --------------------------
    ctx = types.SimpleNamespace(dev=dev, smi=smi, cfg=cfg, counted=counted, timed=timed,
                                counts=counts, bits=bits, host_copy=host_copy, wer_of=wer_of,
                                c1_feats=c1_feats)
    phase_frontend(ctx)

    # ---- 12-14. T, TT and AD: triphones and adaptation ---------------------
    phase_tri_decode(ctx)
    phase_tri_train(ctx)
    phase_adapt(ctx)

    print(f"main path launches, all paths: {counts}")

    kernels = []
    replaces = {"analysis": "dsr_tpu/ops/pallas/filterbank.py:188",
                "analysis_beamform": "dsr_tpu/ops/pallas/filterbank.py:338",
                "synthesis": "dsr_tpu/ops/pallas/filterbank.py:710",
                "select": "dsr_tpu/ops/pallas/select.py:221",
                "gsc": "dsr_tpu/ops/pallas/gsc.py:27",
                "steering": "dsr_tpu/ops/pallas/steering.py:34",
                "viterbi": "dsr_tpu/ops/pallas/viterbi.py:35",
                "select_lattice": "dsr_tpu/ops/pallas/select.py:277",
                "analysis_beamform_staged": "dsr_tpu/ops/pallas/filterbank.py:338"}
    sources = {"analysis": "analysis.cu", "analysis_beamform": "analysis.cu",
               "synthesis": "filterbank.cu", "select": "select.cu", "gsc": "gsc.cu",
               "steering": "steering.cu", "viterbi": "viterbi.cu", "select_lattice": "select.cu",
               "analysis_beamform_staged": "analysis.cu"}
    for name, source in sources.items():
        r = record[name]
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
