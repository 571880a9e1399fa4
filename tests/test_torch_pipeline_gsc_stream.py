"""Port parity: the GSC pipeline's streaming and its dereverberation.

`process_streaming` and `process_streaming_subbands` carry the GSC's
active weights from chunk to chunk and re-adapt over each chunk's
re-analysed overlap, as the JAX package does, so the port's streamed
output is held to the JAX package's streamed output (neither equals
offline).  `StreamingRecognizer` over a GSC pipeline gives the JAX
recogniser's words on tests/test_torch_streaming.py's phone task.

Tolerances: streamed waveform and subbands within 1e-4 of the largest
reference magnitude (the block-NLMS state passes through every chunk, so
float32 rounding carries across chunks); words exact, scores within 0.1
(tests/test_streaming_decode.py's tolerance).  Dereverberation: see its
test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import phone_system, rel
from dsr_tpu.asr.am import gmm as jgmm
from dsr_tpu.asr.decoder import topk_decoder as jtk
from dsr_tpu.config import ArrayGeometry as JGeometry
from dsr_tpu.config import BeamformerConfig as JBeamformerConfig
from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.ops import features as jft
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu.pipeline import DsrPipeline as JDsrPipeline
from dsr_tpu.pipeline import StreamingRecognizer as JRecognizer
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.decoder import topk_decoder as tk
from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr_tpu_torch.ops import dereverb as der
from dsr_tpu_torch.ops import filterbank as fb
from dsr_tpu_torch.pipeline import DsrPipeline, StreamingRecognizer

SOURCE = np.array([0.4, 1.2, 0.0])


def _pipes(M, m, **kw):
    jpipe = JDsrPipeline(fb=JFilterbankConfig(M=M, m=m, r=2), geometry=JGeometry.linear(4, 0.05),
                         beamformer=JBeamformerConfig(kind="gsc"), **kw)
    pipe = DsrPipeline(fb=FilterbankConfig(M=M, m=m, r=2), geometry=ArrayGeometry.linear(4, 0.05),
                       beamformer=BeamformerConfig(kind="gsc"), device="cpu", **kw)
    return jpipe, pipe


def test_gsc_streaming_matches_jax_streaming():
    """The example's path (`examples/streaming_beamformer.py`): GSC with the
    Zelinski post-filter, over ragged chunks.  M = 64, m = 4 keeps every
    re-analysed buffer at >= 16 frames, the JAX block-NLMS's block."""
    x = np.random.default_rng(2).standard_normal((4, 9000)).astype(np.float32)
    cuts = [0, 1500, 5000, 5600, 9000]
    chunks = [x[:, a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    jpipe, pipe = _pipes(64, 4, postfilter="zelinski")
    y_ref = np.concatenate([np.asarray(c) for c in jpipe.process_streaming(chunks, SOURCE)])
    y = torch.cat(list(pipe.process_streaming(chunks, SOURCE)))
    assert y.shape == y_ref.shape == (9000,)
    assert rel(y.numpy(), y_ref) < 1e-4
    Y_ref = np.concatenate([np.asarray(c) for c in jpipe.process_streaming_subbands(chunks,
                                                                                      SOURCE)])
    Y = torch.cat(list(pipe.process_streaming_subbands(chunks, SOURCE)))
    assert Y.shape == Y_ref.shape
    assert rel(Y.numpy(), Y_ref) < 1e-4


def test_dereverb_process_is_wpe_then_gsc():
    """`process(dereverb=True)` runs WPE on the analysis output before the
    GSC, as the JAX pipeline does.  Its float32 output cannot be compared
    with the JAX package's: on white-noise subbands of the oversampled
    filterbank (and at the pad frames, whose power is clamped to
    eps = 1e-10) WPE's normal equations have condition numbers ~1e9, and
    float32 results scatter by O(1) around the float64 one in both
    packages (the JAX package's own pipeline test checks only that they
    are finite).  So the pipeline is held to its own composition exactly;
    `wpe` itself is held to the JAX package's on well-conditioned data in
    tests/test_torch_postfilter.py."""
    x = np.random.default_rng(3).standard_normal((4, 8000)).astype(np.float32)
    jpipe, pipe = _pipes(256, 4, dereverb=True)
    y_ref, _ = jpipe.process(x, SOURCE)
    y, feats = pipe.process(x, SOURCE)
    assert y.shape == (8000,) and np.all(np.isfinite(np.asarray(y_ref)))
    assert bool(torch.isfinite(y).all() and torch.isfinite(feats).all())
    A = fb.analysis(torch.as_tensor(x), pipe.fb)
    Y, _ = pipe.beamform_subbands(der.wpe(A), SOURCE)
    assert torch.equal(y, fb.synthesis(Y, pipe.fb, 8000))


def test_streaming_recognizer_over_gsc_matches_jax():
    graph, params, xm, chunks = phone_system(SOURCE)
    jpipe, pipe = _pipes(64, 2)
    Y, _ = jpipe.beamform_subbands(jfb.analysis(jnp.asarray(xm), jpipe.fb), SOURCE)
    cep_mean = np.asarray(jft.mfcc_from_subbands(Y, 64, 16000.0)).mean(axis=0)
    jrec = JRecognizer(jpipe, lambda f: jgmm.loglik(params, f), jtk.build_token_graph(graph),
                       SOURCE, kcap=128, cep_mean=cep_mean)
    jwords, jscore = jrec.run(chunks)
    p = convert.gmm_params(params)
    rec = StreamingRecognizer(pipe, lambda f: gmm.loglik(p, f),
                              tk.build_token_graph(convert.packed_graph(graph), "cpu"), SOURCE,
                              kcap=128, cep_mean=cep_mean)
    words, score = rec.run(chunks)
    assert words == jwords and len(words) > 2
    assert score == pytest.approx(jscore, abs=0.1)
