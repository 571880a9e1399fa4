"""Compose-stages public API of the PyTorch front end.

Counterpart of `dsr_tpu.pipeline.DsrPipeline`: multichannel waveform →
subband analysis (→ WPE dereverberation) → DS, superdirective MVDR or GSC
(block-NLMS) beamform (→ Zelinski or McCowan post-filter) → synthesis,
plus subband MFCC (+ CMN).  It runs on the card unless `device` names
another (`device="cpu"` runs the plain path).

    pipe = DsrPipeline(fb=FilterbankConfig(M=256, m=4, r=2),
                       geometry=ArrayGeometry.circular(8, 0.10),
                       beamformer=BeamformerConfig(kind="mvdr"))
    y, feats = pipe.process(x_multi, source_pos=np.array([0., 2., 0.]))

Streaming: `process_streaming` (enhanced waveform chunks),
`process_streaming_subbands` (mature beamformed subband frames, equal to
offline `process`'s for the fixed beamformers), `StreamingRecognizer`
(audio chunks in, words out through the top-K decoder's chunked decode)
and `StreamingCtcRecognizer` (audio chunks in, CTC labels out through the
chunk-causal `StreamingConformerCtc`).
The GSC's active weights are carried from chunk to chunk; the frames
re-analysed over each chunk's overlap re-adapt, so a streamed GSC output
follows the JAX package's streamed output, not the offline one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from dsr_tpu_torch.asr.decoder import topk_decoder as tk
from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig, FrontendConfig
from dsr_tpu_torch.ops import beamforming as bf
from dsr_tpu_torch.ops import dereverb as der
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.ops import filterbank as fb
from dsr_tpu_torch.ops import postfilter as pf
from dsr_tpu_torch.utils import design
from dsr_tpu_torch.utils.device import resolve


@dataclass
class DsrPipeline:
    fb: FilterbankConfig = field(default_factory=FilterbankConfig)
    geometry: ArrayGeometry = field(default_factory=lambda: ArrayGeometry.linear(8, 0.04))
    beamformer: BeamformerConfig = field(default_factory=BeamformerConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    postfilter: str | None = None   # None | 'zelinski' | 'mccowan'
    dereverb: bool = False
    device: str | torch.device | None = None
    # The diffuse coherence Γ (McCowan) and Γl⁻¹ (MVDR) depend on the
    # geometry only, so they are computed once here (as bench.py hoists
    # Γl⁻¹); each request then costs a batched matvec.
    _gamma: torch.Tensor | None = field(default=None, init=False, repr=False)
    _gamma_inv: torch.Tensor | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.beamformer.kind not in ("ds", "mvdr", "gsc"):
            raise ValueError(f"unknown beamformer kind {self.beamformer.kind!r}")
        if self.postfilter not in (None, "zelinski", "mccowan"):
            raise ValueError(f"unknown postfilter {self.postfilter!r}")
        self.device = resolve(self.device)
        if self.beamformer.kind == "mvdr" or self.postfilter == "mccowan":
            self._gamma = bf.diffuse_coherence(np.asarray(self.geometry.positions), self.fb.M,
                                               float(self.frontend.sample_rate),
                                               self.geometry.sound_speed, self.device)
        if self.beamformer.kind == "mvdr":
            self._gamma_inv = bf.mvdr_precompute(self._gamma, self.beamformer.diagonal_loading)

    def steering_delays(self, source_pos: np.ndarray) -> np.ndarray:
        POS = np.asarray(self.geometry.positions)
        return (
            design.steering_delays(POS, np.asarray(source_pos), self.geometry.sound_speed,
                                   self.frontend.sample_rate)
            / self.frontend.sample_rate
        ).astype(np.float32)

    def _steering(self, source_pos: np.ndarray) -> torch.Tensor:
        """Steering vectors (K, N) complex64 towards a source position."""
        taus = torch.as_tensor(self.steering_delays(source_pos), device=self.device)
        return bf.steering_vectors(taus, self.fb.M, float(self.frontend.sample_rate))

    def weights(self, source_pos: np.ndarray) -> torch.Tensor:
        """Fixed beamformer weights (K, N) complex64 for a source position:
        DS, MVDR, or the GSC's quiescent (DS) weights."""
        v = self._steering(source_pos)
        if self.beamformer.kind == "mvdr":
            return bf.mvdr_weights_from_inv(v, self._gamma_inv)
        return bf.ds_weights(v)

    def beamform_subbands(self, A: torch.Tensor, source_pos: np.ndarray,
                          gsc_state: torch.Tensor | None = None):
        """A: (N, T, K) analysis output → (Y (T, K), new GSC state (K, N-1),
        or None for DS and MVDR)."""
        state = None
        if self.beamformer.kind == "gsc":
            v = self._steering(source_pos)
            c = self.beamformer
            Y, state = bf.gsc_nlms_block(A, bf.ds_weights(v), bf.blocking_matrix(v), mu=c.mu,
                                         eps=c.eps, wa_norm_cap=c.wa_norm_cap, wa0=gsc_state)
        else:
            Y = bf.apply_weights(A, self.weights(source_pos))
        if self.postfilter == "zelinski":
            Y = pf.apply_postfilter(Y, pf.zelinski_weights(A))
        elif self.postfilter == "mccowan":
            Y = pf.apply_postfilter(Y, pf.mccowan_weights(A, self._gamma))
        return Y, state

    def mfcc(self, Y: torch.Tensor) -> torch.Tensor:
        """Subband MFCC of beamformed subbands (..., T, K) with the front
        end's settings → (..., T, num_cepstra)."""
        fe = self.frontend
        return ft.mfcc_from_subbands(Y, self.fb.M, fe.sample_rate, num_mel=fe.num_mel,
                                     num_cepstra=fe.num_cepstra, fmin=fe.fmin, fmax=fe.fmax,
                                     vtln_warp=fe.vtln_warp)

    def process(self, x_multi, source_pos: np.ndarray):
        """(N, S) waveforms → (enhanced waveform (S,), features (T', D))."""
        x = torch.as_tensor(x_multi, dtype=torch.float32, device=self.device)
        A = fb.analysis(x, self.fb)
        if self.dereverb:
            A = der.wpe(A)
        Y, _ = self.beamform_subbands(A, source_pos)
        y = fb.synthesis(Y, self.fb, x.shape[-1])
        feats = self.mfcc(Y)
        if self.frontend.cmn:
            feats = ft.cmn(feats)
        return y, feats

    def _subbands(self, buf: np.ndarray, source_pos: np.ndarray, gsc_state):
        A = fb.analysis(torch.as_tensor(buf, device=self.device), self.fb)
        return self.beamform_subbands(A, source_pos, gsc_state)

    def process_streaming(self, chunks, source_pos: np.ndarray):
        """Iterate (N, block) chunks → yields enhanced (block,) chunks.

        Chunked streaming: each chunk is analysed with L samples of carried
        history so boundary-straddling frames are recomputed; for the fixed
        beamformers the concatenated output matches offline processing to
        filterbank precision; the GSC carries its active weights and
        re-adapts over the re-processed overlap."""
        gsc_state = None
        L = self.fb.L
        buf = None          # trailing input kept for context: last 2L samples
        emitted = 0         # samples emitted, in global coordinates
        consumed = 0        # input samples consumed, global
        for chunk in chunks:
            chunk = np.asarray(chunk, np.float32)
            buf = chunk if buf is None else np.concatenate([buf, chunk], axis=-1)
            consumed += chunk.shape[-1]
            buf_start = consumed - buf.shape[-1]
            Y, gsc_state = self._subbands(buf, source_pos, gsc_state)
            y = fb.synthesis(Y, self.fb, buf.shape[-1])
            mature_end = consumed - L  # needs >= L future samples to be final
            if mature_end > emitted:
                yield y[emitted - buf_start: mature_end - buf_start]
                emitted = mature_end
            keep = min(2 * L, buf.shape[-1])
            buf = buf[..., -keep:]
        if buf is not None and consumed > emitted:  # flush the tail
            buf_start = consumed - buf.shape[-1]
            Y, gsc_state = self._subbands(buf, source_pos, gsc_state)
            y = fb.synthesis(Y, self.fb, buf.shape[-1])
            yield y[emitted - buf_start:]

    def process_streaming_subbands(self, chunks, source_pos: np.ndarray):
        """Iterate (N, block) chunks → yields mature beamformed subband
        frames (Tc, K) complex64, frame-exact against offline analysis.

        Frame g of the offline analysis covers x[g·D−P, g·D−P+L); it is
        emitted once its window lies inside the consumed input.  The carried
        buffer keeps >= 2L samples trimmed to a D-aligned global offset, so
        re-analysed boundary frames see exactly the offline window (the
        chunk-local zero pad only touches frames already emitted).  The GSC
        carries its active weights and re-adapts over the overlap."""
        D, L = self.fb.D, self.fb.L
        gsc_state = None
        buf = None
        consumed = 0
        emitted_f = 0           # global frames emitted
        chunks = iter(chunks)
        pending = next(chunks, None)
        while pending is not None:
            chunk = np.asarray(pending, np.float32)
            pending = next(chunks, None)
            buf = chunk if buf is None else np.concatenate([buf, chunk], axis=-1)
            consumed += chunk.shape[-1]
            buf_start = consumed - buf.shape[-1]
            Y, gsc_state = self._subbands(buf, source_pos, gsc_state)
            if pending is None:
                mf = buf_start // D + Y.shape[-2]  # flush: all local frames
            else:
                mf = consumed // D                 # fully windowed frames only
            lo = emitted_f - buf_start // D
            hi = mf - buf_start // D
            if hi > lo:
                yield Y[..., lo:hi, :]
                emitted_f = mf
            keep = min(buf.shape[-1], 2 * L + (consumed % D))
            buf = buf[..., -keep:]


class StreamingRecognizer:
    """Streaming recognition: multichannel audio chunks in, words out, equal
    to the whole-utterance decode.

    The carried state is the front end's sample buffer, the GSC's active
    weights (if any) and the decoder's (states, scores) token carry;
    everything else is frame-local.  Token
    tables accumulate per chunk; `finish()` runs the utterance-final
    traceback.

    `loglik_fn`: features (T, D) → (T, P) acoustic log-likelihoods (e.g.
    `functools.partial(gmm.loglik, params)`).  `cep_mean`: fixed cepstral
    mean to subtract (utterance-level CMN is not causal).  The decoder
    graph `token_graph` lies on the pipeline's device.
    """

    def __init__(self, pipe: DsrPipeline, loglik_fn, token_graph: tk.TokenGraph,
                 source_pos: np.ndarray, kcap: int = 256, beam: float = 1e9,
                 cep_mean: np.ndarray | None = None):
        self.pipe = pipe
        self.loglik_fn = loglik_fn
        self.graph = token_graph
        self.source_pos = np.asarray(source_pos)
        self.kcap = min(kcap, token_graph.num_states)
        self.beam = beam
        self.cep_mean = (None if cep_mean is None else
                         torch.as_tensor(np.asarray(cep_mean, np.float32), device=pipe.device))
        self.carry = tk.stream_start(token_graph, self.kcap)
        self._toks: list[tuple[torch.Tensor, torch.Tensor]] = []

    def _feats(self, Y: torch.Tensor) -> torch.Tensor:
        f = self.pipe.mfcc(Y)
        return f if self.cep_mean is None else f - self.cep_mean

    def run(self, chunks):
        """Consume an iterable of (N, block) chunks; returns (words (olabel
        ids), score), identical to decoding the concatenated utterance
        offline with the same fixed cep_mean."""
        for Y in self.pipe.process_streaming_subbands(chunks, self.source_pos):
            ll = self.loglik_fn(self._feats(Y))
            self.carry, toks = tk.decode_chunk(self.graph, ll, self.carry, self.kcap, self.beam)
            self._toks.append((toks[0], toks[1]))
        return self.finish()

    def finish(self):
        if not self._toks:
            return [], float("-inf")   # no audio consumed
        tok_states = torch.cat([t for t, _ in self._toks], dim=0)
        tok_arcs = torch.cat([a for _, a in self._toks], dim=0)
        olabs, score = tk.traceback(self.graph, tok_states, tok_arcs, self.carry)
        return [int(w) for w in olabs if w], float(score)


class StreamingCtcRecognizer:
    """CTC-path streaming recognition: multichannel audio chunks →
    beamformed subbands → features → `StreamingConformerCtc` steps →
    incremental greedy labels.

    The carried state is the front end's sample buffer, the model's
    `StreamState` and the greedy decoder's last label; features wait in a
    buffer until a whole model step (4·chunk frames) is there.  The emitted
    rows are the offline chunk-causal pass's, so the labels equal the
    greedy decode of `model(all features)` up to the last flushed frame.
    `finish()` flushes the model's one chunk of latency; the features
    after the last whole model chunk (< 4·chunk frames) are dropped, as
    the offline pass drops them on chunk-aligned input.

    `cep_mean` / `cep_scale`: fixed cepstral normalisation (subtracted, then
    divided; utterance CMN is not causal).  The model lies on the
    pipeline's device.
    """

    def __init__(self, pipe: DsrPipeline, model, source_pos: np.ndarray,
                 cep_mean: np.ndarray | None = None, cep_scale: np.ndarray | None = None):
        self.pipe = pipe
        self.model = model
        self.source_pos = np.asarray(source_pos)
        fixed = lambda a: (None if a is None else  # noqa: E731
                           torch.as_tensor(np.asarray(a, np.float32), device=pipe.device))
        self.cep_mean, self.cep_scale = fixed(cep_mean), fixed(cep_scale)
        self.state = model.init_state()
        self._fbuf = torch.zeros((0, model.feat_dim), device=pipe.device)
        self._prev_label = -1
        self.words: list[int] = []

    def _feats(self, Y: torch.Tensor) -> torch.Tensor:
        f = self.pipe.mfcc(Y)
        if self.cep_mean is not None:
            f = f - self.cep_mean
        if self.cep_scale is not None:
            f = f / self.cep_scale
        return f

    def _emit(self, logits: torch.Tensor, n_new: int) -> list[int]:
        out = []
        for i in logits[:n_new].argmax(dim=-1).tolist():
            if i != self._prev_label and i != 0:
                out.append(i)
            self._prev_label = i
        self.words.extend(out)
        return out

    @torch.no_grad()
    def run(self, chunks):
        """Consume an iterable of (N, block) audio chunks; yields the labels
        each model step emits (steps that emit none yield nothing)."""
        C4 = 4 * self.model.chunk
        for Y in self.pipe.process_streaming_subbands(chunks, self.source_pos):
            self._fbuf = torch.cat([self._fbuf, self._feats(Y)])
            while self._fbuf.shape[0] >= C4:
                raw, self._fbuf = self._fbuf[:C4], self._fbuf[C4:]
                logits, n_new, self.state = self.model.step(raw, self.state)
                out = self._emit(logits, n_new)
                if out:
                    yield out

    @torch.no_grad()
    def finish(self) -> list[int]:
        """Flush the model's buffered chunk; returns every label emitted."""
        self._emit(*self.model.finish(self.state))
        return self.words
