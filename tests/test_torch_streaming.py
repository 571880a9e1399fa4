"""The port's streaming API (`DsrPipeline.process_streaming`,
`process_streaming_subbands`, `StreamingRecognizer`) against the JAX
package's recogniser and against the port's own offline path: a small
phone-task HCLG and a seeded diagonal GMM, both built by the JAX package
and carried across (`convert.packed_graph`, `convert.gmm_params`), on a
4-mic array recording of a corpus utterance cut into ragged chunks.

Tolerances: words exact; the recognisers' scores within 0.1 (the
tolerance of tests/test_streaming_decode.py: the two packages' MFCC and
GMM float32 sums differ in order); streamed subband frames within 1e-5 of
the largest offline magnitude (the filterbank's gate); the streamed
waveform within 1e-4 of the JAX package's streamed waveform (the MVDR gate
of tests/test_torch_beamforming.py) and, over D-aligned chunks and away
from the first and last L samples, which see other pads, within 1e-3 of the
offline one (the gate of tests/test_pipeline.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import phone_system, rel
from dsr_tpu.asr.am import gmm as jgmm
from dsr_tpu.asr.decoder import topk_decoder as jtk
from dsr_tpu.config import ArrayGeometry as JGeometry
from dsr_tpu.config import BeamformerConfig as JBeamformer
from dsr_tpu.config import FilterbankConfig as JFilterbank
from dsr_tpu.ops import features as jft
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu.pipeline import DsrPipeline as JPipeline
from dsr_tpu.pipeline import StreamingRecognizer as JRecognizer
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.decoder import topk_decoder as tk
from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.ops import filterbank as fb
from dsr_tpu_torch.pipeline import DsrPipeline, StreamingRecognizer

SR = 16000.0
SOURCE = np.array([0.4, 1.2, 0.0])


@pytest.fixture(scope="module")
def system():
    return phone_system(SOURCE)


def _pipe(kind, device="cpu"):
    return DsrPipeline(fb=FilterbankConfig(M=64, m=2, r=2),
                       geometry=ArrayGeometry.linear(4, 0.05),
                       beamformer=BeamformerConfig(kind=kind), device=device)


def test_streaming_recognizer_matches_jax_and_offline(system):
    graph, params, xm, chunks = system
    jpipe = JPipeline(fb=JFilterbank(M=64, m=2, r=2), geometry=JGeometry.linear(4, 0.05),
                      beamformer=JBeamformer(kind="ds"))
    Y, _ = jpipe.beamform_subbands(jfb.analysis(jnp.asarray(xm), jpipe.fb), SOURCE)
    cep_mean = np.asarray(jft.mfcc_from_subbands(Y, 64, SR)).mean(axis=0)
    jrec = JRecognizer(jpipe, lambda f: jgmm.loglik(params, f), jtk.build_token_graph(graph),
                       SOURCE, kcap=128, cep_mean=cep_mean)
    jwords, jscore = jrec.run(chunks)

    pipe = _pipe("ds")
    p = convert.gmm_params(params)
    tg = tk.build_token_graph(convert.packed_graph(graph), "cpu")
    rec = StreamingRecognizer(pipe, lambda f: gmm.loglik(p, f), tg, SOURCE, kcap=128,
                              cep_mean=cep_mean)
    words, score = rec.run(chunks)
    assert words == jwords and len(words) > 2
    assert score == pytest.approx(jscore, abs=0.1)

    Y_off, _ = pipe.beamform_subbands(fb.analysis(torch.as_tensor(xm), pipe.fb), SOURCE)
    feats = ft.mfcc_from_subbands(Y_off, 64, SR) - torch.as_tensor(cep_mean)
    olabs, off_score = tk.decode(tg, gmm.loglik(p, feats), kcap=128)
    assert words == [int(w) for w in olabs if w]
    assert score == pytest.approx(float(off_score), abs=1e-3)


def test_streamed_subband_frames_equal_offline_frames(system):
    _, _, xm, chunks = system
    pipe = _pipe("mvdr")
    frames = torch.cat(list(pipe.process_streaming_subbands(chunks, SOURCE)), dim=0)
    Y_off, _ = pipe.beamform_subbands(fb.analysis(torch.as_tensor(xm), pipe.fb), SOURCE)
    assert frames.shape == Y_off.shape
    assert rel(frames.numpy(), Y_off.numpy()) < 1e-5


def test_streamed_waveform_equals_jax_and_offline(system):
    """Over the ragged chunks the JAX package's own streamed waveform
    differs from its offline one by ~1 % (its carried buffer is not
    D-aligned, so the frame grid moves), and the port's follows it; over
    chunks of 4,000 samples (a multiple of D) both equal offline."""
    _, _, xm, chunks = system
    pipe = _pipe("mvdr")
    y = torch.cat(list(pipe.process_streaming(chunks, SOURCE)))
    jpipe = JPipeline(fb=JFilterbank(M=64, m=2, r=2), geometry=JGeometry.linear(4, 0.05),
                      beamformer=JBeamformer(kind="mvdr"))
    y_ref = np.concatenate([np.asarray(c) for c in jpipe.process_streaming(chunks, SOURCE)])
    assert y.shape == y_ref.shape == (xm.shape[-1],)
    assert rel(y.numpy(), y_ref) < 1e-4
    blocks = [xm[:, i:i + 4000] for i in range(0, xm.shape[-1], 4000)]
    y = torch.cat(list(pipe.process_streaming(blocks, SOURCE)))
    y_off, _ = pipe.process(xm, SOURCE)
    L = pipe.fb.L
    assert rel(y[L:-L].numpy(), y_off[L:-L].numpy()) < 1e-3
