"""The port's streaming Conformer-CTC (`dsr_tpu_torch.models.
streaming_conformer`) and `pipeline.StreamingCtcRecognizer` against the
JAX package's on the CPU, flax's parameters carried across by
`convert.streaming_conformer` (relative-position tables, LayerNorm scales
and biases drawn at random).  vocab 7, dim 32, 2 layers, 2 heads, chunk 4,
left 2; inputs made with numpy from seeds.

Tolerances:
- offline logits and each step's rows against JAX: 1e-4 of the largest
  magnitude (float32 products in another order);
- the port streamed against the port offline: the JAX test's gate, atol
  2e-4, rtol 1e-4 (tests/test_streaming_conformer.py:46);
- the chunk-local check: the JAX test's atol 1e-5;
- labels and words: identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import randomized, rel
from dsr_tpu.models import streaming_conformer as jsc
from dsr_tpu_torch import convert
from dsr_tpu_torch.models import streaming_conformer as psc

SR = 16000.0


def _pair(vocab=7, feat_dim=13, seed=1):
    jm = jsc.StreamingConformerCtc(vocab=vocab, dim=32, layers=2, heads=2, chunk=4, left=2,
                                   feat_dim=feat_dim)
    params = randomized(jm.init(jax.random.PRNGKey(seed), jnp.zeros((80, feat_dim))), seed)
    pm = psc.StreamingConformerCtc(vocab, 32, 2, 2, chunk=4, left=2, feat_dim=feat_dim,
                                   device="cpu")
    pm.load_state_dict(convert.streaming_conformer(params), strict=True)
    return jm, params, pm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _greedy(logits):
    out, prev = [], -1
    for i in np.asarray(logits).argmax(-1):
        if i != prev and i != 0:
            out.append(int(i))
        prev = int(i)
    return out


def test_offline_logits_match_jax(pair):
    jm, params, pm = pair
    feats = np.random.default_rng(2).standard_normal((4 * 4 * 5 + 9, 13)).astype(np.float32)
    ref = np.asarray(jm.apply(params, feats))
    with torch.no_grad():
        out = pm(torch.as_tensor(feats)).numpy()
    assert out.shape == ref.shape == ((feats.shape[0] - 7) // 4 + 1, 8)
    assert rel(out, ref) <= 1e-4


def test_streamed_equals_offline_and_each_step_equals_jax(pair):
    jm, params, pm = pair
    C, n_chunks = pm.chunk, 6
    feats = np.random.default_rng(3).standard_normal((4 * C * n_chunks, 13)).astype(np.float32)
    jstep = jax.jit(lambda p, c, s: jm.apply(p, c, s, method="step"))
    jstate, state = jm.init_state(), pm.init_state()
    parts = []
    with torch.no_grad():
        off = pm(torch.as_tensor(feats)).numpy()
        for n in range(n_chunks):
            raw = feats[4 * C * n: 4 * C * (n + 1)]
            lj, nj, jstate = jstep(params, raw, jstate)
            lg, n_new, state = pm.step(torch.as_tensor(raw), state)
            assert n_new == int(nj) == (0 if n == 0 else C)
            if n_new:
                assert rel(lg[:n_new].numpy(), np.asarray(lj)[:n_new]) <= 1e-4
            parts.append(lg[:n_new].numpy())
        tail, n_tail = pm.finish(state)
        tj, ntj = jm.apply(params, jstate, method="finish")
    assert n_tail == int(ntj) == C - 1
    assert rel(tail.numpy(), np.asarray(tj)) <= 1e-4
    parts.append(tail.numpy())
    got = np.concatenate(parts)
    assert got.shape == off.shape == (C * n_chunks - 1, 8)
    np.testing.assert_allclose(got, off, atol=2e-4, rtol=1e-4)
    assert sum(len(p) > 0 for p in parts) > 1
    assert psc.greedy_ctc_stream([torch.as_tensor(p) for p in parts if len(p)]).tolist() == \
        _greedy(off)


def test_streaming_state_is_chunk_local(pair):
    """tests/test_streaming_conformer.py:59-85 on the port: audio before the
    visible context (left chunks and the conv tail of 2 layers) does not
    change the last chunk's logits."""
    _, _, pm = pair
    C, N = pm.chunk, 16
    feats = np.random.default_rng(5).standard_normal((4 * C * N, 13)).astype(np.float32)
    feats2 = feats.copy()
    feats2[:4 * C] += 10.0

    def last_logits(f):
        state, out = pm.init_state(), None
        with torch.no_grad():
            for n in range(N):
                out, _, state = pm.step(torch.as_tensor(f[4 * C * n:4 * C * (n + 1)]), state)
        return out.numpy()

    np.testing.assert_allclose(last_logits(feats), last_logits(feats2), atol=1e-5)


def test_streaming_ctc_recognizer_matches_jax():
    """The JAX test's scene (tests/test_streaming_conformer.py:99-125): a
    6-mic linear array, MVDR, M = 64 m = 4 r = 2, 1.6 s in chunks of 4,000
    samples, a fixed zero cepstral mean; the port's words equal the JAX
    recognizer's and the port's offline chunk-causal greedy decode."""
    from dsr_tpu.config import ArrayGeometry as JGeometry
    from dsr_tpu.config import BeamformerConfig as JBeamformerConfig
    from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
    from dsr_tpu.pipeline import DsrPipeline as JPipeline
    from dsr_tpu.pipeline import StreamingCtcRecognizer as JRecognizer
    from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
    from dsr_tpu_torch.ops import filterbank as fb
    from dsr_tpu_torch.pipeline import DsrPipeline, StreamingCtcRecognizer
    from golden import room as groom

    rng = np.random.default_rng(7)
    pos = np.array([0.5, 1.2, 0.0])
    jpipe = JPipeline(fb=JFilterbankConfig(M=64, m=4, r=2), geometry=JGeometry.linear(6, 0.04),
                      beamformer=JBeamformerConfig(kind="mvdr"))
    pipe = DsrPipeline(fb=FilterbankConfig(M=64, m=4, r=2), geometry=ArrayGeometry.linear(6, 0.04),
                       beamformer=BeamformerConfig(kind="mvdr"), device="cpu")
    x = rng.standard_normal(int(1.6 * SR))
    xm = groom.simulate(x, np.asarray(pipe.geometry.positions), pos, SR, snr_db=20.0,
                        rng=rng).astype(np.float32)
    chunks = [xm[:, i:i + 4000] for i in range(0, xm.shape[-1], 4000)]
    jm, params, pm = _pair(vocab=9, seed=3)
    zero = np.zeros(13)

    jrec = JRecognizer(jpipe, jm, params, pos, cep_mean=zero)
    for _ in jrec.run(iter(chunks)):
        pass
    words_j = jrec.finish()

    rec = StreamingCtcRecognizer(pipe, pm, pos, cep_mean=zero)
    inc = [w for out in rec.run(iter(chunks)) for w in out]
    words = rec.finish()
    assert words[:len(inc)] == inc and len(words) > 0
    assert words == words_j

    Y, _ = pipe.beamform_subbands(fb.analysis(torch.as_tensor(xm), pipe.fb), pos)
    feats = rec._feats(Y)
    n_full = feats.shape[0] // (4 * pm.chunk) * 4 * pm.chunk
    with torch.no_grad():
        assert words == _greedy(pm(feats[:n_full]).numpy())
