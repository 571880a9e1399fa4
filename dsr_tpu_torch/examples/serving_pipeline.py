"""Serving from files: WAV corpus → C++ batched prefetch loader → the card
→ staged fused analysis+beamform kernel → MFCC → LVCSR decode.

Counterpart of `examples/serving_pipeline.py`.  The path a serving host
runs:
  - the native loader's worker pool (`utils/audio.BatchLoader`) decodes
    the NEXT batch of WAVs on host threads while the card computes;
  - each batch is uploaded (`torch.from_numpy`, pinned, non-blocking) and
    staged once as the fused kernel's bank (`stage_for_beamform`); each
    utterance is one launch of the staged fused analysis + MVDR kernel;
  - MFCC of the beamformed subbands, a fixed (13, num_pdfs) projection
    into pdf scores (the corpus is noise: a trained AM drops in here), and
    the batched top-K decode over `LvcsrConfig()`'s graph (the select
    kernel once a frame);
  - pipelined: the front end of up to `depth` batches is queued on the
    card before the oldest batch's decode blocks for its traceback, so
    loading, upload and the front end overlap the decode.  The sequential
    baseline finishes every batch before it loads the next.

    python -m dsr_tpu_torch.examples.serving_pipeline [n_utts]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from dsr_tpu_torch.asr import lvcsr
from dsr_tpu_torch.asr.decoder import topk_decoder as tk
from dsr_tpu_torch.config import ArrayGeometry, FilterbankConfig
from dsr_tpu_torch.ops import beamforming as bf
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.ops import filterbank as fb
from dsr_tpu_torch.utils import profiling
from dsr_tpu_torch.utils.audio import BatchLoader, write_wav
from dsr_tpu_torch.utils.design import steering_delays
from dsr_tpu_torch.utils.device import resolve

SR = 16000
SECS = 4.0
CH = 8
BATCH = 4
SOURCE = np.array([0.0, 1.5, 0.0])
KCAP, BEAM = 256, 40.0         # the decode cell's token cap and beam


def make_corpus(root: str, n: int) -> list[str]:
    """n utterances of CH channels x SECS s of noise, as PCM16 WAV files."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        x = 0.1 * rng.standard_normal((CH, int(SR * SECS))).astype(np.float32)
        p = os.path.join(root, f"utt{i:03d}.wav")
        write_wav(p, x, SR)
        paths.append(p)
    return paths


@dataclass
class Server:
    """The serving path's state on one device: the filterbank config, the
    MVDR weights (K, CH), the pdf projection and the decoder graph (decoded
    with KCAP tokens and BEAM)."""

    cfg: FilterbankConfig
    w: torch.Tensor
    proj: torch.Tensor
    task: lvcsr.LvcsrTask
    tg: tk.TokenGraph
    num_samples: int

    @property
    def device(self) -> torch.device:
        return self.w.device

    def upload(self, audio: np.ndarray) -> torch.Tensor:
        """A loader batch (B, CH, S) onto the device: pinned host memory and
        a non-blocking copy on the card."""
        x = torch.from_numpy(audio)
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x

    def features(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, CH, S) on the device → MFCC (B, T, 13): the bank staged once,
        one fused analysis + MVDR launch per utterance."""
        with profiling.scope("serving.beamform"):
            xp = fb.stage_for_beamform(audio)
            Y = torch.stack([fb.analysis_beamform_staged(xp, i, self.w, self.cfg,
                                                         self.num_samples)
                             for i in range(xp.shape[0])])
        with profiling.scope("serving.features"):
            return ft.mfcc_from_subbands(Y, self.cfg.M, float(SR))

    def logliks(self, audio: torch.Tensor) -> torch.Tensor:
        return self.features(audio) @ self.proj

    def decode(self, ll: torch.Tensor):
        """(B, T, P) → (olabels (B, T), scores (B,)); blocks for the traceback."""
        with profiling.scope("serving.decode"):
            return tk.decode_batch(self.tg, ll, np.full(ll.shape[0], ll.shape[1]),
                                   kcap=KCAP, beam=BEAM)

    def words(self, olabels: torch.Tensor) -> list[list[str]]:
        return [[self.task.words.name(int(w)) for w in row if w] for row in olabels.cpu()]


def make_server(device=None, task: lvcsr.LvcsrTask | None = None,
                tg: tk.TokenGraph | None = None) -> Server:
    """The serving state on `device` (the card unless "cpu"): the bench
    graph (`LvcsrConfig()`, built or loaded from the cache unless given),
    M = 256 m = 4 r = 2, an 8-mic circular 0.10 m array steered at
    SOURCE with superdirective MVDR weights (loading 1e-2)."""
    dev = resolve(device)
    task = lvcsr.build_task(lvcsr.LvcsrConfig()) if task is None else task
    tg = tk.build_token_graph(task.graph, device=dev) if tg is None else tg
    proj = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (13, task.num_pdfs)).astype(np.float32) * 0.1, device=dev)
    cfg = FilterbankConfig(M=256, m=4, r=2)
    POS = np.asarray(ArrayGeometry.circular(CH, 0.1).positions)
    taus = (steering_delays(POS, SOURCE, 343.0, SR) / SR).astype(np.float32)
    Gamma = bf.diffuse_coherence(POS, cfg.M, float(SR), 343.0, dev)
    w = bf.mvdr_weights_from_inv(
        bf.steering_vectors(torch.as_tensor(taus, device=dev), cfg.M, float(SR)),
        bf.mvdr_precompute(Gamma, 1e-2))
    return Server(cfg, w, proj, task, tg, int(SR * SECS))


def _sync(server: Server) -> None:
    if server.device.type == "cuda":
        torch.cuda.synchronize()


def serve_pipelined(server: Server, paths: list[str], depth: int = 3):
    """The serving loop with up to `depth` batches' front ends in flight →
    (batches served, the decodes in corpus order).  A ragged last batch is
    served at its own size."""
    out, inflight = [], []
    with BatchLoader(paths, BATCH, max_frames=server.num_samples, max_channels=CH) as loader:
        for audio, _ in loader:
            inflight.append(server.logliks(server.upload(audio)))
            if len(inflight) > depth:
                out.append(server.decode(inflight.pop(0)))
        out += [server.decode(ll) for ll in inflight]
    return len(out), out


def serve_sequential(server: Server, paths: list[str]):
    """Each batch loaded, uploaded, beamformed and decoded before the next."""
    out = []
    with BatchLoader(paths, BATCH, max_frames=server.num_samples, max_channels=CH) as loader:
        for audio, _ in loader:
            out.append(server.decode(server.logliks(server.upload(audio))))
            _sync(server)
    return len(out), out


def stage_costs(server: Server, paths: list[str]) -> dict[str, float]:
    """Seconds of one batch's stages: the loader's cold `next()` and the next
    (prefetched, as in a serving loop) one, the upload, and the front end +
    decode of a warm batch."""
    with BatchLoader(paths, BATCH, max_frames=server.num_samples, max_channels=CH) as loader:
        t0 = time.perf_counter()
        audio, _ = next(loader)
        t_cold = time.perf_counter() - t0
        server.decode(server.logliks(server.upload(audio)))        # warm-up
        t0 = time.perf_counter()
        next(loader)
        t_next = time.perf_counter() - t0
    _sync(server)
    t0 = time.perf_counter()
    x = server.upload(audio)
    _sync(server)
    t_up = time.perf_counter() - t0
    t0 = time.perf_counter()
    server.decode(server.logliks(x))
    _sync(server)
    return {"load_cold": t_cold, "load_next": t_next, "upload": t_up,
            "compute": time.perf_counter() - t0}


def main(n_utts: int = 16, device=None, task: lvcsr.LvcsrTask | None = None,
         tg: tk.TokenGraph | None = None) -> dict:
    server = make_server(device, task, tg)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = make_corpus(root, n_utts)
        t_gen = time.perf_counter() - t0
        cost = stage_costs(server, paths)
        t0 = time.perf_counter()
        nb, _ = serve_pipelined(server, paths)
        t_pipe = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve_sequential(server, paths)
        t_seq = time.perf_counter() - t0
    audio_secs = n_utts * SECS
    print(f"corpus: {n_utts} utts x {CH} ch x {SECS:.0f} s  (generated in {t_gen:.1f}s)")
    print(f"per-batch stage costs: load {cost['load_cold'] * 1e3:.0f} ms cold, "
          f"{cost['load_next'] * 1e3:.1f} ms prefetched | upload {cost['upload'] * 1e3:.1f} ms | "
          f"beamform+features+decode {cost['compute'] * 1e3:.1f} ms")
    print(f"pipelined wall: {t_pipe:.2f}s for {audio_secs:.0f} audio-s "
          f"({audio_secs / t_pipe:.1f} audio-s/s sustained, {nb} batches)")
    print(f"sequential baseline: {t_seq:.2f}s ({audio_secs / t_seq:.1f} audio-s/s) -> "
          f"pipelining gains {t_seq / t_pipe:.2f}x")
    print(f"device-side compute alone: {BATCH * SECS / cost['compute']:.0f} audio-s/s")
    return {"pipelined": audio_secs / t_pipe, "sequential": audio_secs / t_seq, **cost}


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
