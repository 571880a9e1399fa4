"""Port parity: subband AEC (NLMS, Kalman, voice-prompt cancellation) and
speech-activity detection of `dsr_tpu_torch.ops.{aec,sad}` against
`dsr_tpu.ops.{aec,sad}`, at tests/test_enhancement.py's shapes, on inputs
made with numpy from a seed.

Tolerances: E and W within 1e-4 of their largest magnitude (complex64
recurrences over 150-200 frames whose sums run in another order);
decisions and segments equal; the log-likelihood ratio within 1e-4
absolute (a mean of float32 logs over 17 bins).
"""

import numpy as np
import torch

from _torch_parity import rel
from dsr_tpu.ops import aec as jaec
from dsr_tpu.ops import sad as jsad
from dsr_tpu_torch.ops import aec, sad


def echo_case(seed, T, K, taps, noise):
    """Far end F and the mic D = its echo through a random (K, taps)
    subband path, plus noise (tests/test_enhancement.py's construction)."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((T, K)) + 1j * rng.standard_normal((T, K))
    true_w = (rng.standard_normal((K, taps)) + 1j * rng.standard_normal((K, taps))) * 0.5
    D = np.zeros((T, K), complex)
    hist = np.zeros((K, taps), complex)
    for t in range(T):
        hist = np.roll(hist, 1, axis=1)
        hist[:, 0] = F[t]
        D[t] = np.sum(np.conj(true_w) * hist, axis=1) + noise * (
            rng.standard_normal(K) + 1j * rng.standard_normal(K))
    return D.astype(np.complex64), F.astype(np.complex64)


def test_nlms_and_voice_prompt_cancellation_match_jax():
    D, F = echo_case(3, 200, 9, 3, 0.0)
    for fn, kw in ((aec.nlms_aec, {"taps": 3}), (aec.cancel_voice_prompt, {"taps": 3, "mu": 0.3})):
        E_ref, W_ref = (np.asarray(a) for a in getattr(jaec, fn.__name__)(D, F, **kw))
        E, W = fn(torch.as_tensor(D), torch.as_tensor(F), **kw)
        assert E.dtype == W.dtype == torch.complex64 and W.shape == (9, 3)
        assert rel(E.numpy(), E_ref) < 1e-4 and rel(W.numpy(), W_ref) < 1e-4
    erle = 10 * np.log10(np.mean(np.abs(D[100:]) ** 2) / np.mean(np.abs(E.numpy()[100:]) ** 2))
    assert erle > 20.0


def test_kalman_aec_matches_jax():
    D, F = echo_case(4, 150, 9, 2, 0.01)
    E_ref, W_ref = (np.asarray(a) for a in jaec.kalman_aec(D, F, taps=2))
    E, W = aec.kalman_aec(torch.as_tensor(D), torch.as_tensor(F), taps=2)
    assert rel(E.numpy(), E_ref) < 1e-4 and rel(W.numpy(), W_ref) < 1e-4


def test_energy_vad_matches_jax():
    rng = np.random.default_rng(5)
    T = 120
    p = np.full(T, 1e-4)
    p[40:70] = 1e-2
    p = (p * (1 + 0.1 * rng.random(T))).astype(np.float32)
    d = sad.energy_vad(torch.as_tensor(p))
    assert d.dtype == torch.int32
    assert np.array_equal(d.numpy(), np.asarray(jsad.energy_vad(p)))
    assert d[45:65].float().mean() > 0.9 and d[:35].float().mean() < 0.2
    for seed in range(6):      # random powers, other thresholds and hangovers
        q = (10.0 ** np.random.default_rng(seed).uniform(-4, -1, 200)).astype(np.float32)
        for thr, hang in ((3.0, 0), (3.0, 3), (1.0, 8)):
            assert np.array_equal(sad.energy_vad(torch.as_tensor(q), thr, hang).numpy(),
                                  np.asarray(jsad.energy_vad(q, thr, hang)))


def test_sohn_vad_matches_jax():
    rng = np.random.default_rng(6)
    T, K = 80, 17
    noise_psd = np.ones(K, np.float32)
    P = (rng.chisquare(2, (T, K)) / 2).astype(np.float32)
    P[30:50] *= 8.0
    d_ref, llr_ref = (np.asarray(a) for a in jsad.sohn_vad(P, noise_psd))
    d, llr = sad.sohn_vad(torch.as_tensor(P), torch.as_tensor(noise_psd))
    assert d.dtype == torch.int32
    assert np.array_equal(d.numpy(), d_ref)
    assert float(np.abs(llr.numpy() - llr_ref).max()) < 1e-4
    assert d[32:48].float().mean() > 0.9
    d2_ref, llr2_ref = (np.asarray(a) for a in jsad.sohn_vad(P, noise_psd, 0.9, 0.5, 3))
    d2, llr2 = sad.sohn_vad(torch.as_tensor(P), torch.as_tensor(noise_psd), 0.9, 0.5, 3)
    assert np.array_equal(d2.numpy(), d2_ref)
    assert float(np.abs(llr2.numpy() - llr2_ref).max()) < 1e-4


def test_segments_from_vad_match_jax():
    d = np.zeros(200, np.int32)
    d[30:80] = 1
    d[85:90] = 1    # close run: merged
    d[150:155] = 1  # too short: dropped
    assert sad.segments_from_vad(d) == jsad.segments_from_vad(d) == [(25, 95)]
    rng = np.random.default_rng(7)
    for _ in range(5):
        r = (rng.random(300) < rng.uniform(0.2, 0.8)).astype(np.int32)
        for kw in ({}, {"min_speech": 3, "min_gap": 2, "pad": 1}):
            assert (sad.segments_from_vad(torch.as_tensor(r), **kw)
                    == jsad.segments_from_vad(r, **kw))
